"""No module under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program (nor its C++ oracle): each
import's top-level name, the part before the first dot, compared whole."""

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "dilithium_tpu"}
REFERENCE_ALLOWED = {"__future__", "hashlib", "typing", "numpy", "benchmark"}


def _modules(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules(harness.BENCH_DIR)), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(harness.BENCH_DIR, "reference"))),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_stands_alone(path):
    found = set(_imports(path))
    assert found <= REFERENCE_ALLOWED, found - REFERENCE_ALLOWED
    assert "dilithium_tpu_torch" not in found


def test_names_compared_whole():
    """The port's name begins with the JAX package's: it is allowed."""
    assert "dilithium_tpu_torch".split(".")[0] not in FORBIDDEN
    assert not {"dilithium_tpu_torch", "jax_extra"} & set(harness.FORBIDDEN)
