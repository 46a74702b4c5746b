"""Per-level Dilithium round-3 parameter sets.

The port's own copy of the constants, the `DilithiumParams` dataclass and
its derived widths and XOF block budgets, and the three level sets; the
JAX package holds the same definitions in `dilithium_tpu/params.py`, and
`tests/test_torch_isolation.py` holds the two equal field by field.
Constants follow the round-3 CRYSTALS-Dilithium v3.1 specification.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Scheme-wide constants (dilithium-256/params.h:33-35)
Q = 8380417  # 2^23 - 2^13 + 1
N = 256
D = 13  # power2round dropped bits
QINV = 58728449  # q^-1 mod 2^32 (for Montgomery, R = 2^32)
MONT_R = 4193792  # 2^32 mod q
MONT_R2 = 2365951  # (2^32)^2 mod q

SEEDBYTES = 32
CRHBYTES = 64  # v3.1: mu / rhoprime are 64 bytes
TRBYTES = 32  # v3.1: tr = H(rho||t1, 32)

SHAKE128_RATE = 168
SHAKE256_RATE = 136

# Per-poly packed byte lengths
POLYT1_PACKEDBYTES = 320  # 10 bits/coeff
POLYT0_PACKEDBYTES = 416  # 13 bits/coeff


@dataclasses.dataclass(frozen=True)
class DilithiumParams:
    """Frozen per-level constants (hashable, so usable as a cache key)."""

    level: int
    K: int  # rows of A
    L: int  # cols of A
    eta: int  # secret coefficient bound
    tau: int  # challenge weight
    beta: int  # tau * eta
    gamma1: int  # mask range (power of two)
    gamma2: int  # low-order rounding range, (q-1)/alpha
    omega: int  # max total hint weight

    # derived packing widths
    @property
    def gamma1_bits(self) -> int:  # 18 or 20
        return (self.gamma1 * 2 - 1).bit_length()

    @property
    def polyz_packedbytes(self) -> int:
        return N * self.gamma1_bits // 8  # 576 or 640

    @property
    def polyw1_packedbytes(self) -> int:
        # w1 coeff range: [0, 43] (6 bits) at level 2, [0, 15] (4 bits) else
        return 192 if self.gamma2 == (Q - 1) // 88 else 128

    @property
    def w1_bits(self) -> int:
        return 6 if self.gamma2 == (Q - 1) // 88 else 4

    @property
    def polyeta_packedbytes(self) -> int:
        return 96 if self.eta == 2 else 128  # 3 or 4 bits/coeff

    @property
    def eta_bits(self) -> int:
        return 3 if self.eta == 2 else 4

    @property
    def pk_bytes(self) -> int:
        return SEEDBYTES + self.K * POLYT1_PACKEDBYTES

    @property
    def sk_bytes(self) -> int:
        return (
            2 * SEEDBYTES
            + TRBYTES
            + (self.K + self.L) * self.polyeta_packedbytes
            + self.K * POLYT0_PACKEDBYTES
        )

    @property
    def sig_bytes(self) -> int:
        return SEEDBYTES + self.L * self.polyz_packedbytes + self.omega + self.K

    @property
    def max_hint_weight(self) -> int:
        return self.omega

    # --- fixed XOF block budgets for masked (batch) rejection sampling ---
    # The specification streams SHAKE blocks until enough coefficients
    # are accepted. A batch instead draws a fixed, provably-sufficient
    # number of blocks and fills by masked prefix-scan;
    # the accepted sequence is identical to streaming semantics whenever the
    # budget suffices. Failure probabilities (per poly) are astronomically
    # small — see ops/sampling.py docstrings for the Chernoff bounds.
    @property
    def uniform_blocks(self) -> int:
        # SHAKE128, 168 B/block → 56 candidates/block, accept p≈0.99902.
        # 5 blocks = 280 candidates ≥ 256: P[>24 rejects] < 1e-40
        # (C(280,25)·(2^13/2^23)^25). One block fewer than the r1-r3 budget
        # of 6 — cuts the ExpandA XOF and compaction window by 1/6; failure
        # still reported exactly via the ok flag, never silently wrong.
        return 5

    @property
    def eta_blocks(self) -> int:
        # SHAKE256, 136 B/block → 272 4-bit candidates/block.
        # eta=2: p=15/16 → 2 blocks (544 cand): P[fail] < 1e-79
        # eta=4: p=9/16  → 3 blocks (816 cand): P[fail] < 1e-53
        return 2 if self.eta == 2 else 3

    @property
    def mask_blocks(self) -> int:
        # ExpandMask has no rejection: gamma1_bits*256/8 bytes exactly.
        nbytes = self.polyz_packedbytes
        return -(-nbytes // SHAKE256_RATE)  # 5 for both 576 and 640

    @property
    def ball_blocks(self) -> int:
        # SampleInBall: 8 sign bytes + geometric rejection bytes for tau
        # Fisher–Yates steps (p_accept ≥ (256-tau)/256 ≈ 0.77).
        # 2 blocks = 272 bytes: P[fail] < 1e-30.
        return 2


LEVELS: Tuple[int, ...] = (2, 3, 5)

_PARAMS = {
    2: DilithiumParams(
        level=2, K=4, L=4, eta=2, tau=39, beta=78,
        gamma1=1 << 17, gamma2=(Q - 1) // 88, omega=80,
    ),
    3: DilithiumParams(
        level=3, K=6, L=5, eta=4, tau=49, beta=196,
        gamma1=1 << 19, gamma2=(Q - 1) // 32, omega=55,
    ),
    5: DilithiumParams(
        level=5, K=8, L=7, eta=2, tau=60, beta=120,
        gamma1=1 << 19, gamma2=(Q - 1) // 32, omega=75,
    ),
}


def get_params(level: int) -> DilithiumParams:
    """Return the frozen parameter set for security level 2, 3 or 5."""
    try:
        return _PARAMS[level]
    except KeyError:
        raise ValueError(f"unknown Dilithium level {level!r}; expected one of {LEVELS}")
