"""Batched 256-point NTT over Z_q (q = 8380417).

The port of `dilithium_tpu/ops/ntt.py`. `ntt` / `invntt` run kernel K4
(`csrc/ntt.cu`) on a CUDA tensor and `ntt_plain` / `invntt_plain`,
indexed butterflies on int64, on a CPU one. Both use the standard
Dilithium twiddles (r = 1753, bit-reversed order) indexed exactly as the
JAX package builds its tables, and produce canonical residues, so they are
bit-identical to it. Polynomials are int32 [..., 256] canonical.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.params import N, Q
from dilithium_tpu_torch.ops.reduce import add_mod, mont_mul

_ROOT = 1753  # primitive 512th root of unity mod q


def _bitrev8(x: int) -> int:
    return int(f"{x:08b}"[::-1], 2)


_ZETAS = np.array([pow(_ROOT, _bitrev8(i), Q) for i in range(N)], dtype=np.int64)
_IZETAS = (-_ZETAS) % Q
_N_INV = pow(N, -1, Q)
# plain factors of the JAX package's Montgomery scalings: the product form
# also removes the R^-1 that `pointwise` / `matvec` leave in their output
_SCALE_PRODUCT = _N_INV * (1 << 32) % Q
_SCALE_PLAIN = _N_INV


def _shoup(z: np.ndarray) -> np.ndarray:
    return (z.astype(np.uint64) << np.uint64(32)) // np.uint64(Q)


# K4's table: forward zeta, its Shoup companion, inverse zeta, companion
_ZTAB = np.stack([_ZETAS, _shoup(_ZETAS), _IZETAS, _shoup(_IZETAS)]).astype(np.uint32)


@lru_cache(maxsize=None)
def _ztab_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ZTAB.view(np.int32)).to(device)


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 (forward): int32 [B, 256] -> int32 [B, 256]."""
    b = x.shape[0]
    zetas = torch.from_numpy(_ZETAS).to(x.device)
    x = x.to(torch.int64)
    length = N // 2
    while length >= 1:
        nblk = N // (2 * length)
        v = x.view(b, nblk, 2, length)
        z = zetas[nblk:2 * nblk].view(1, nblk, 1)
        t = v[:, :, 1] * z % Q
        a = v[:, :, 0]
        x = torch.stack([(a + t) % Q, (a - t) % Q], dim=2).view(b, N)
        length //= 2
    return x.to(torch.int32)


def invntt_plain(x: torch.Tensor, from_product: bool = True) -> torch.Tensor:
    """Plain version of K4 (inverse): int32 [B, 256] -> int32 [B, 256]."""
    b = x.shape[0]
    izetas = torch.from_numpy(_IZETAS).to(x.device)
    x = x.to(torch.int64)
    length = 1
    while length <= N // 2:
        nblk = N // (2 * length)
        v = x.view(b, nblk, 2, length)
        z = izetas[2 * nblk - 1 - torch.arange(nblk, device=x.device)].view(1, nblk, 1)
        a, c = v[:, :, 0], v[:, :, 1]
        x = torch.stack([(a + c) % Q, (a - c) * z % Q], dim=2).view(b, N)
        length *= 2
    scale = _SCALE_PRODUCT if from_product else _SCALE_PLAIN
    return (x * scale % Q).to(torch.int32)


def _run(x: torch.Tensor, inverse: bool, from_product: bool = True) -> torch.Tensor:
    flat = x.reshape(-1, N).to(torch.int32).contiguous()
    if not _kernels.on_cuda(flat):
        out = invntt_plain(flat, from_product) if inverse else ntt_plain(flat)
        return out.reshape(x.shape)
    scale = _SCALE_PRODUCT if from_product else _SCALE_PLAIN
    out = torch.empty_like(flat)
    _kernels.launch(
        "ntt", flat, flat.data_ptr(), out.data_ptr(), flat.shape[0],
        _ztab_on(flat.device).data_ptr(), int(inverse), scale,
        int(_shoup(np.array([scale]))[0]),
    )
    return out.reshape(x.shape)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT: canonical int32 [..., 256] -> NTT domain, canonical."""
    return _run(x, False)


def invntt(x: torch.Tensor, from_product: bool = True) -> torch.Tensor:
    """Inverse NTT. from_product=True for input from `pointwise` /
    `matvec`, which carries an R^-1 factor the scaling removes."""
    return _run(x, True, from_product)


def pointwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NTT-domain product a * b * R^-1 mod q (the JAX package's Montgomery
    convention, undone by `invntt(from_product=True)`). Only a is copied
    to int64: pass a broadcast operand as b."""
    return mont_mul(a, b)


def matvec(a_hat: torch.Tensor, s_hat: torch.Tensor) -> torch.Tensor:
    """[..., K, L, 256] x [..., L, 256] -> [..., K, 256], sum over l of
    pointwise products, one l at a time. A broadcast a_hat (one key for
    many lanes) is never widened beyond [..., K, 256], nor copied to
    int64: s_hat is the operand `mont_mul` widens."""
    acc = None
    for l in range(a_hat.shape[-2]):
        prod = mont_mul(s_hat[..., l, :].unsqueeze(-2), a_hat[..., l, :])
        acc = prod if acc is None else add_mod(acc, prod)
    return acc


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic product a * b mod (X^256 + 1, q), both canonical int32
    [..., 256]."""
    return invntt(pointwise(ntt(a), ntt(b)))
