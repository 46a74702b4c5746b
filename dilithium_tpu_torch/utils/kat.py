"""KAT vector loading and host-side hashing helpers.

The port's own copy of `dilithium_tpu/utils/kat.py` (that module imports
no JAX, but the port imports nothing of the JAX package). The corpus has
100 NIST-style vectors per level as per-component hex files
(`{z,rho,k,tr,s1,s2,t0,t1,m,mlen,zs,h,c}_{2,3,5}.txt`, one vector a
line) in KAT_DIR: the directory DILITHIUM_KAT_DIR names, else `KAT/` at
the root of the checkout (the JAX module's default is a path outside
the repository).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List

import numpy as np

KAT_DIR = os.environ.get(
    "DILITHIUM_KAT_DIR", os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "KAT"))

_COMPONENTS = ("z", "rho", "k", "tr", "s1", "s2", "t0", "t1", "m", "mlen", "zs", "h", "c")


def load_kat(level: int, count: int | None = None) -> Dict[str, List[bytes]]:
    """Load KAT vectors for a level. Returns dict of component -> list of bytes.

    'mlen' entries are ints; 'm' entries are trimmed to mlen bytes.
    """
    out: Dict[str, list] = {}
    for comp in _COMPONENTS:
        path = os.path.join(KAT_DIR, f"{comp}_{level}.txt")
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if count is not None:
            lines = lines[:count]
        if comp == "mlen":
            out[comp] = [int(ln, 16) for ln in lines]
        else:
            out[comp] = [bytes.fromhex(ln) for ln in lines]
    out["m"] = [m[:n] for m, n in zip(out["m"], out["mlen"])]
    return out


def crh(*parts: bytes, out_len: int = 64) -> bytes:
    """SHAKE256 digest of the concatenation: host-side mu/tr computation."""
    h = hashlib.shake_256()
    for p in parts:
        h.update(p)
    return h.digest(out_len)


def to_u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8)


def stack_u8(bs: List[bytes]) -> np.ndarray:
    return np.stack([to_u8(b) for b in bs])
