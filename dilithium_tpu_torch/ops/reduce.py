"""Elementwise mod-q arithmetic on int32 coefficient tensors (q = 8380417).

Canonical coefficients are int32 in [0, q) (every canonical value is below
2^23, so int32 holds them and their sums exactly); centered values are
int32 in (-q/2, q/2]. Products are taken in int64 and reduced with `%`,
which gives the same residues as the JAX package's 16-bit-limb Montgomery
arithmetic.
"""

from __future__ import annotations

import torch

from dilithium_tpu_torch.params import Q

R_INV = pow(1 << 32, -1, Q)  # Montgomery R^-1 mod q, R = 2^32


def csubq(a: torch.Tensor) -> torch.Tensor:
    """Map [0, 2q) -> [0, q)."""
    return torch.where(a >= Q, a - Q, a)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q for canonical inputs."""
    return csubq(a + b)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q for canonical inputs."""
    return csubq(a + Q - b)


def mont_mul(a: torch.Tensor, b) -> torch.Tensor:
    """a * b * R^-1 mod q for canonical inputs, as int32 in [0, q)."""
    prod = (a.to(torch.int64) * b) % Q
    return (prod * R_INV % Q).to(torch.int32)


def center(a: torch.Tensor) -> torch.Tensor:
    """Canonical [0, q) -> centered (-q/2, q/2]."""
    a = a.to(torch.int32)
    return torch.where(a > (Q - 1) // 2, a - Q, a)


def uncenter(a: torch.Tensor) -> torch.Tensor:
    """Centered (-q, q) -> canonical [0, q)."""
    a = a.to(torch.int32)
    return torch.where(a < 0, a + Q, a)
