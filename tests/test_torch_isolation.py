"""The PyTorch port stands apart from the JAX package: its own parameter
sets equal the JAX package's, its own binding of the C++ oracle gives the
same bytes as the JAX package's binding, and no module of the port (nor
`chip_smoke.py`) imports anything named `dilithium_tpu` or `jax`."""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest

from dilithium_tpu import oracle as joracle
from dilithium_tpu import params as jparams
from dilithium_tpu_torch import oracle, params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("level", [2, 3, 5])
def test_params_equal_jax(level):
    mine, ref = params.get_params(level), jparams.get_params(level)
    fields = [f.name for f in dataclasses.fields(jparams.DilithiumParams)]
    assert fields == [f.name for f in dataclasses.fields(params.DilithiumParams)]
    props = sorted(n for n, v in vars(jparams.DilithiumParams).items() if isinstance(v, property))
    assert props == sorted(n for n, v in vars(params.DilithiumParams).items() if isinstance(v, property))
    for name in fields + props:
        assert getattr(mine, name) == getattr(ref, name), name
    consts = [n for n in vars(jparams) if n.isupper() and not n.startswith("_")]
    assert consts and consts == [n for n in vars(params) if n.isupper() and not n.startswith("_")]
    for name in consts:
        assert getattr(params, name) == getattr(jparams, name), name


def test_oracle_binding_matches_jax_binding():
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    mus = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    assert oracle.sizes(2) == joracle.sizes(2)
    pk, sk = oracle.keygen(2, seeds)
    pk_j, sk_j = joracle.keygen(2, seeds)
    np.testing.assert_array_equal(pk, pk_j)
    np.testing.assert_array_equal(sk, sk_j)
    sig, att = oracle.sign(2, sk, mus)
    sig_j, att_j = joracle.sign(2, sk_j, mus)
    np.testing.assert_array_equal(sig, sig_j)
    np.testing.assert_array_equal(att, att_j)
    sig[3, 40] ^= 1
    ok = oracle.verify(2, pk, mus, sig)
    assert ok.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(ok, joracle.verify(2, pk_j, mus, sig))


def _imported(path: str):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_port_imports_the_jax_package():
    files = glob.glob(os.path.join(REPO, "dilithium_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported(f)
           if m.split(".")[0] in ("dilithium_tpu", "jax", "jaxlib")]
    assert not bad, bad
