"""ctypes binding to the C++ Dilithium oracle (`cpp/liboracle.so`).

The port's own binding of the shared C++ sources in `cpp/`: keygen, sign
and verify over batches of numpy arrays, for checking the port's outputs
byte for byte. The library is built on first use with
`make -s -C cpp liboracle.so`, under an flock on `<repo>/.oracle_build.lock`,
the lock file the JAX package's binding takes too, so processes that load
either binding never link over each other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(_REPO, "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "liboracle.so")
_LOCK_PATH = os.path.join(_REPO, ".oracle_build.lock")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """Run make (a no-op when the library is current), then load it. If
    make cannot run but a built library exists, load that."""
    import fcntl

    try:
        with open(_LOCK_PATH, "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                subprocess.run(["make", "-s", "-C", _CPP_DIR, "liboracle.so"], check=True)
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)
    except (OSError, subprocess.CalledProcessError):
        if not os.path.exists(_LIB_PATH):
            raise
    lib = ctypes.CDLL(_LIB_PATH)
    for name in ("oracle_pk_bytes", "oracle_sk_bytes", "oracle_sig_bytes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int]
    lib.oracle_keygen_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p]
    lib.oracle_sign_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, _i32p]
    lib.oracle_verify_batch.argtypes = [ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, _i32p]
    return lib


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _p8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def sizes(level: int):
    """-> (pk_bytes, sk_bytes, sig_bytes) of the level."""
    lib = _lib()
    return lib.oracle_pk_bytes(level), lib.oracle_sk_bytes(level), lib.oracle_sig_bytes(level)


def keygen(level: int, seeds: np.ndarray):
    """seeds uint8 [B, 32] -> (pk [B, pk_bytes], sk [B, sk_bytes])."""
    seeds = _u8(seeds)
    n = seeds.shape[0]
    pkb, skb, _ = sizes(level)
    pk = np.zeros((n, pkb), dtype=np.uint8)
    sk = np.zeros((n, skb), dtype=np.uint8)
    _lib().oracle_keygen_batch(level, n, _p8(seeds), _p8(pk), _p8(sk))
    return pk, sk


def sign(level: int, sk: np.ndarray, mu: np.ndarray):
    """sk [B, sk_bytes], mu [B, 64] -> (sig [B, sig_bytes], attempts int32 [B])."""
    sk, mu = _u8(sk), _u8(mu)
    n = sk.shape[0]
    sig = np.zeros((n, sizes(level)[2]), dtype=np.uint8)
    att = np.zeros(n, dtype=np.int32)
    _lib().oracle_sign_batch(level, n, _p8(sk), _p8(mu), _p8(sig), _p32(att))
    return sig, att


def verify(level: int, pk: np.ndarray, mu: np.ndarray, sig: np.ndarray):
    """pk [B, pk_bytes], mu [B, 64], sig [B, sig_bytes] -> bool [B]."""
    pk, mu, sig = _u8(pk), _u8(mu), _u8(sig)
    n = pk.shape[0]
    res = np.zeros(n, dtype=np.int32)
    _lib().oracle_verify_batch(level, n, _p8(pk), _p8(mu), _p8(sig), _p32(res))
    return res.astype(bool)
