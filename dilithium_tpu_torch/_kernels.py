"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` files are compiled by nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface (sm_90a), loaded with ctypes. The library's file name
carries a hash of the sources and flags, so a stale build is never loaded.
The build runs at the first launch on a CUDA tensor, under an flock so
parallel processes do not link over each other; importing this module
builds nothing.

Each C entry point launches one kernel on the given stream and returns
`cudaGetLastError()`; `launch` makes the tensors' device current, passes
its current stream, raises when the result is not 0 and otherwise adds
one to the kernel's count in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as c_void_p). K1-K4
# carry the signing path; K5-K7 run on the kernel micro-bench
# (`bench_kernels.py`) and its A/B rigs (`tools/`).
_SIGNATURES = {
    "sponge": [_P, _P, _I, _I, _I, _I, _I, _P],
    "mask_limbs": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ball": [_P, _P, _P, _I, _I, _I, _P],
    "ntt": [_P, _P, _I, _P, _I, ctypes.c_uint32, ctypes.c_uint32, _P],
    "permute": [_P, _P, _I, _L, _L, _P],
    "sponge_planes": [_P, _P, _I, _I, _I, _I, _P],
    "ball_bitplane": [_P, _P, _P, _I, _I, _I, _P],
}

# launches per kernel since the last reset_launches()
LAUNCHES = {name: 0 for name in _SIGNATURES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other
    device (there is no plain path to fall back to there)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel for device {t.device}")


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libdilithium_kernels_{h.hexdigest()[:16]}.so")


def _compile_and_link(path: str) -> None:
    stem = f"{path}.{os.getpid()}"
    cus = [src for src in _sources() if src.endswith(".cu")]
    objs = [f"{stem}.{os.path.basename(cu)}.o" for cu in cus]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, cu],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)
    ]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [f"{os.path.basename(cu)} ({proc.returncode}):\n{out[-4000:]}"
              for cu, proc, out in zip(cus, procs, outs) if proc.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", f"{stem}.tmp", *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    with open(path + ".log", "w") as log:
        log.write("".join(outs) + (link.stdout + link.stderr if link else ""))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(f"{stem}.tmp", path)


def build() -> str:
    """Compile csrc/*.cu into the hashed library unless it exists; return
    its path. The compiler's output is kept beside it as `<lib>.log`."""
    import fcntl

    path = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                _compile_and_link(path)
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)
    return path


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, "dk_" + name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def launch(name: str, t: torch.Tensor, *args) -> None:
    """Launch kernel `name` through its C entry point on t's device, on
    that device's current stream (passed as the last argument), and count
    it. The device is made current for the call: a launch on another
    device's stream fails."""
    fn = getattr(library(), "dk_" + name)
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {err}")
    LAUNCHES[name] += 1
