"""ctypes binding to the C++ Dilithium oracle (`cpp/liboracle.so`).

The port's own binding of the shared C++ sources in `cpp/`: keygen, sign
and verify over batches of numpy arrays, for checking the port's outputs
byte for byte, the reference NTT (`ntt`, `invntt`, `pointwise`, a
polynomial at a time), and the multithreaded mu hash (`crh_batch`) that the bytes
API's `compute_mu_many` runs on the host. The library is built on first use with
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
    lib.oracle_crh_batch.argtypes = [ctypes.c_int, _u8p, ctypes.c_int, _u8p,
                                     ctypes.POINTER(ctypes.c_int64), _u8p, ctypes.c_int]
    lib.oracle_crh_batch.restype = None
    lib.oracle_ntt.argtypes = [_i32p]
    lib.oracle_invntt.argtypes = [_i32p]
    lib.oracle_pointwise.argtypes = [_i32p, _i32p, _i32p]
    for name in ("oracle_ntt", "oracle_invntt", "oracle_pointwise"):
        getattr(lib, name).restype = None
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


def crh_batch(trs: np.ndarray, messages, nthreads: int = 0) -> np.ndarray:
    """mu = SHAKE256(tr || M, 64) over a ragged batch, on a native thread
    pool: trs uint8 [n, 32] (one a message) or [32] (shared), messages a
    sequence of n bytes-like of any lengths -> uint8 [n, 64]. nthreads <= 0
    lets the library pick."""
    lib = _lib()
    n = len(messages)
    trs = _u8(trs)
    if trs.shape[-1] != 32 or trs.ndim not in (1, 2):
        # the native code reads exactly 32 bytes a row
        raise ValueError(f"trs must be [32] or [n, 32] bytes; got {trs.shape}")
    tr_stride = 0 if trs.ndim == 1 else 32
    if tr_stride and trs.shape[0] != n:
        raise ValueError(f"trs rows {trs.shape[0]} != {n} messages")
    # each message is converted to bytes once, and the lengths and the
    # joined blob both come from that form: for a memoryview or array of
    # wider items, len() counts items, not bytes
    bs = [m if type(m) is bytes else bytes(m) for m in messages]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, bs), dtype=np.int64, count=n), out=offsets[1:])
    blob = b"".join(bs)
    msgs = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
    mus = np.zeros((n, 64), dtype=np.uint8)
    lib.oracle_crh_batch(n, _p8(trs), tr_stride, _p8(msgs),
                         offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _p8(mus), nthreads)
    return mus


def _per_poly(fn, *polys: np.ndarray) -> np.ndarray:
    """fn(out, *inputs) over int32 [..., 256] polynomials, one a call;
    the first input is copied into out (in-place transforms) or out
    starts at zero (pointwise)."""
    ins = [np.ascontiguousarray(a, dtype=np.int32) for a in polys]
    if len(ins) == 1:
        out = ins[0].copy()
        for row in out.reshape(-1, 256):
            fn(_p32(row))
        return out
    out = np.zeros_like(ins[0])
    for ro, *rs in zip(out.reshape(-1, 256), *(a.reshape(-1, 256) for a in ins)):
        fn(_p32(ro), *(_p32(r) for r in rs))
    return out


def ntt(a: np.ndarray) -> np.ndarray:
    """The reference forward NTT of canonical int32 polynomials [..., 256]."""
    return _per_poly(_lib().oracle_ntt, a)


def invntt(a: np.ndarray) -> np.ndarray:
    """The reference inverse NTT, scaled by 1/256, of canonical int32
    polynomials [..., 256]."""
    return _per_poly(_lib().oracle_invntt, a)


def pointwise(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference pointwise product a * b * R^-1 mod q of two canonical
    int32 [..., 256] polynomial batches of one shape."""
    return _per_poly(_lib().oracle_pointwise, a, b)
