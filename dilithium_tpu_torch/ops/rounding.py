"""Power2Round, Decompose, HighBits/LowBits, MakeHint, UseHint and the
infinity-norm check.

The port of `dilithium_tpu/ops/rounding.py`:
branch-free int32 arithmetic with the spec's magic-constant forms.
Canonical inputs are int32 in [0, q); centered ones int32 in (-q/2, q/2].
"""

from __future__ import annotations

from typing import Tuple

import torch

from dilithium_tpu_torch.params import D, Q, DilithiumParams


def power2round(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical a -> (a1 in [0, 1023], a0 centered in (-2^12, 2^12])."""
    a = a.to(torch.int32)
    a1 = (a + (1 << (D - 1)) - 1) >> D
    return a1, a - (a1 << D)


def decompose(a: torch.Tensor, p: DilithiumParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical a -> (a1, a0) with a = a1 * 2*gamma2 + a0 (mod q), a0
    centered in [-gamma2, gamma2] with the q-1 boundary folded."""
    a = a.to(torch.int32)
    a1 = (a + 127) >> 7
    if p.gamma2 == (Q - 1) // 32:
        a1 = ((a1 * 1025 + (1 << 21)) >> 22) & 15
    else:  # gamma2 == (Q - 1) // 88
        a1 = (a1 * 11275 + (1 << 23)) >> 24
        a1 = a1 ^ (((43 - a1) >> 31) & a1)
    a0 = a - a1 * (2 * p.gamma2)
    a0 = a0 - ((((Q - 1) // 2 - a0) >> 31) & Q)
    return a1, a0


def highbits(a: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    return decompose(a, p)[0]


def lowbits(a: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    return decompose(a, p)[1]


def make_hint(a0: torch.Tensor, a1: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """Hint bit (uint8 0/1) per coefficient; a0 centered, a1 high part."""
    g2 = p.gamma2
    hint = (a0 > g2) | (a0 < -g2) | ((a0 == -g2) & (a1 != 0))
    return hint.to(torch.uint8)


def use_hint(h: torch.Tensor, a: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """Recover w1 (int32) from hint bits h (0/1) and canonical a: where h is
    set, the high part moves one step up if a0 > 0 and down otherwise,
    wrapping mod 16 (gamma2 = (q-1)/32) or between 43 and 0 (gamma2 =
    (q-1)/88)."""
    a1, a0 = decompose(a, p)
    if p.gamma2 == (Q - 1) // 32:
        up, dn = (a1 + 1) & 15, (a1 - 1) & 15
    else:
        up = torch.where(a1 == 43, 0, a1 + 1)
        dn = torch.where(a1 == 0, 43, a1 - 1)
    return torch.where(h.bool(), torch.where(a0 > 0, up, dn), a1)


def norm_exceeds(a: torch.Tensor, bound: int, dim=None) -> torch.Tensor:
    """True where |a| >= bound for CENTERED a (the reject condition),
    reduced with any() over `dim` when given. Center canonical values first
    (the JAX function does so itself for uint32 input)."""
    bad = a.abs() >= bound
    return bad if dim is None else bad.any(dim=dim)
