"""The PyTorch port imports on a machine without JAX, Triton or nvcc.

Each check runs in a fresh interpreter in which `import jax`,
`import triton` and `import dilithium_tpu` fail, and every process start
is recorded: importing every module of the package must need none of
them, start no compiler and load no kernel library.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# about three times a probe's time in a loaded tier-1 run: a hang fails its
# own test and leaves the suite its clock
PROBE_TIMEOUT = 60

_PROBE = r"""
import subprocess, sys
sys.modules["jax"] = None        # import jax -> ImportError
sys.modules["triton"] = None
sys.modules["dilithium_tpu"] = None  # the JAX package
started = []
_popen = subprocess.Popen.__init__
def _record(self, *args, **kwargs):
    started.append(args[0] if args else kwargs.get("args"))
    return _popen(self, *args, **kwargs)
subprocess.Popen.__init__ = _record

import importlib, pkgutil
import dilithium_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dilithium_tpu_torch.__path__, "dilithium_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from dilithium_tpu_torch import _kernels

loaded = [m for m, v in sys.modules.items() if v is not None]
assert not [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))], "jax imported"
assert not [m for m in loaded if m == "triton" or m.startswith("triton.")], "triton imported"
assert not [m for m in loaded if m == "dilithium_tpu" or m.startswith("dilithium_tpu.")], "JAX package imported"
assert not started, f"processes started: {started}"
assert _kernels.library.cache_info().currsize == 0, "kernel library loaded"
print("imported", len(names), "modules:", " ".join(sorted(names)))
"""


def _probe(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # the test workers share the cores
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=PROBE_TIMEOUT)


def test_package_imports_without_jax_triton_or_nvcc():
    proc = _probe(_PROBE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for mod in ("api", "__main__", "mxu", "scheme", "trace", "convert", "_kernels", "ops.keccak", "ops.ntt",
                "parallel", "parallel.mesh", "parallel.service", "tools.run_multihost", "tools.kat_replay",
                "utils", "utils.kat",
                "ops.sampling", "ops.pack", "ops.rounding", "ops.reduce", "params",
                "oracle", "bench_kernels", "tools.xof_exp", "tools.ball_exp",
                "tools.kernel_ab", "tools.round_profile", "tools.ball_edges", "tools.verify_cases",
                "tools.sweep_window"):
        assert f"dilithium_tpu_torch.{mod}" in proc.stdout, mod


@pytest.mark.parametrize("path", ["scheme.keygen", "mxu.sign_stream_mxu"])
def test_cpu_path_runs_without_jax(path):
    """The plain path signs on the CPU with JAX unimportable and no build."""
    code = _PROBE + r"""
import numpy as np, torch
from dilithium_tpu_torch import mxu, params, scheme
p = params.get_params(2)
kp = scheme.keygen(torch.zeros(32, dtype=torch.uint8), p)
assert bool(kp.ok)
if "%s" == "mxu.sign_stream_mxu":
    res = mxu.sign_stream_mxu(mxu.build_operators(kp.sk, p), torch.zeros((2, 64), dtype=torch.uint8), p, window=2)
    assert bool(res.ok.all())
assert not started and _kernels.library.cache_info().currsize == 0
assert all(v == 0 for v in _kernels.launches().values())
print("ok")
""" % path
    proc = _probe(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_kernel_bench_runs_on_the_cpu():
    """`bench_kernels --cpu` runs every row's plain version at a tiny size
    and prints one JSON line last."""
    code = _PROBE + r"""
import json, torch
from dilithium_tpu_torch import bench_kernels
if not torch.cuda.is_available():  # without --cpu the bench needs a card
    assert bench_kernels.main(["256", "8"]) == 1
assert bench_kernels.main(["256", "8", "--xof-batch", "64", "--ball-batch", "64", "--reps", "1", "--cpu"]) == 0
assert not started and _kernels.library.cache_info().currsize == 0
assert all(v == 0 for v in _kernels.launches().values())
"""
    proc = _probe(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["route"] == "plain versions on the CPU"
    assert len(res["rows"]) == 12 and all(r["ms"] > 0 for r in res["rows"].values())
    assert set(res["ab"]) == {"xof 66B->160w", "ball level 3"}
    assert all(len(ms) == 3 for sides in res["ab"].values() for ms in sides.values())
