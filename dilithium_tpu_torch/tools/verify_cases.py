"""Signatures that a verifier must reject, one or more rows for each
corruption class of the JAX package's negative tests (`tests/test_negative.py`):

  flip      one byte's low bit flipped in each region: c_tilde (first and
            last byte), z (first and middle byte), the hint positions and
            the hint counts;
  message   the right signature over another message (mu ^ 1);
  key       a signature made under another key;
  z_range   the first polynomial of z decoding to gamma1 (all-zero bytes);
  padding   junk in the last byte of the hint positions;
  bitflip   one random bit flipped anywhere in the signature;
  fill      an all-zero and an all-ones signature.

`chip_smoke.py` and `tests/test_torch_verify.py` both build their rows here.
"""

from __future__ import annotations

import numpy as np

from dilithium_tpu_torch.params import SEEDBYTES, DilithiumParams

CLASSES = ("flip", "message", "key", "z_range", "padding", "bitflip", "fill")
N_BITFLIPS = 3


def negative_cases(sig: np.ndarray, mu: np.ndarray, foreign_sig: np.ndarray,
                   foreign_mu: np.ndarray, p: DilithiumParams, seed: int = 0):
    """sig uint8 [n >= 5, sig_bytes] valid signatures of mu uint8 [n, 64]
    under one key; foreign_sig [sig_bytes] a signature of foreign_mu [64]
    under another key. -> (sig uint8 [R, sig_bytes], mu uint8 [R, 64],
    class name of each row)."""
    rng = np.random.default_rng(seed)
    nz = p.L * p.polyz_packedbytes
    sigs, mus, names = [], [], []

    def add(s, m, name):
        sigs.append(s)
        mus.append(m)
        names.append(name)

    for off in (0, SEEDBYTES - 1, SEEDBYTES, SEEDBYTES + nz // 2, SEEDBYTES + nz, SEEDBYTES + nz + p.omega):
        s = sig[0].copy()
        s[off] ^= 1
        add(s, mu[0], "flip")
    add(sig[1], mu[1] ^ 1, "message")
    add(foreign_sig, foreign_mu, "key")
    s = sig[2].copy()
    s[SEEDBYTES:SEEDBYTES + p.polyz_packedbytes] = 0
    add(s, mu[2], "z_range")
    s = sig[3].copy()
    s[SEEDBYTES + nz + p.omega - 1] = 255
    add(s, mu[3], "padding")
    for _ in range(N_BITFLIPS):
        s = sig[4].copy()
        s[rng.integers(0, p.sig_bytes)] ^= 1 << int(rng.integers(0, 8))
        add(s, mu[4], "bitflip")
    for fill in (0x00, 0xFF):
        add(np.full_like(sig[0], fill), mu[0], "fill")
    return np.stack(sigs), np.stack(mus), names
