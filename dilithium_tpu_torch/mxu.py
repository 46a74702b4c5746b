"""One-key signing and verification over dense int8 operators (int8 GEMMs
on the card).

The port of `dilithium_tpu/mxu.py`. For a fixed key,
w = INTT(A_hat . NTT(y)) and c*s1, c*s2, c*t0 are linear in y and c, so
the key is expanded once into dense matrices and every attempt runs as
int8 x int8 -> int32 products (`torch._int_mm`):

  * wy_cat int8 [L*256, 3*K*256]: the y -> w map (negacyclic convolution
    matrices of A = INTT(A_hat)) in 3 balanced base-256 limbs, side by side;
  * c_cat int8 [256, (L+3K)*256]: [s1 | s2 | t0_lo | t0_hi] convolution
    matrices (t0 in base-128 digits, so a negated digit still fits int8).

y enters as 3 int8 limb planes straight from the mask kernel; the limb
products recombine mod q in a short Horner chain.

Verification is linear in (z, c) the same way: w' = A z - c (t1 << d),
with A z through the signer's y -> w matrix (`wz_cat`, the same bytes as
`wy_cat`) and c (t1 << d) through t1_cat int8 [256, 3*K*256], the limbs
of the convolution matrices of centered t1 << d (`build_verify_operators`,
`verify_mxu`, `MxuVerifier`).

`torch._int_mm` on CUDA wants its second operand column-major, so both
operators are stored that way (`gemm_layout`), once per key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from dilithium_tpu_torch.params import D, N, Q, TRBYTES, DilithiumParams
from dilithium_tpu_torch import scheme, trace
from dilithium_tpu_torch.ops import keccak, ntt, pack, rounding, sampling
from dilithium_tpu_torch.ops.reduce import center, sub_mod, uncenter


class KeyOperators(NamedTuple):
    """Dense per-key operators (see the module docstring)."""
    wy_cat: torch.Tensor  # int8 [L*256, 3*K*256], column-major
    c_cat: torch.Tensor  # int8 [256, (L+3K)*256], column-major
    key: torch.Tensor  # uint8 [32]
    tr: torch.Tensor  # uint8 [32]


def gemm_layout(m: torch.Tensor) -> torch.Tensor:
    """The same matrix stored column-major: the second-operand layout of
    `torch._int_mm` on CUDA."""
    return m.t().contiguous().t()


def _to_limbs_i8(m_centered: torch.Tensor):
    """Centered int32 in (-q/2, q/2] -> 3 balanced base-256 int8 digits."""
    return tuple(d.to(torch.int8) for d in sampling._limbs(m_centered.to(torch.int32)))


def _conv_matrix(s_centered: torch.Tensor) -> torch.Tensor:
    """Negacyclic convolution matrix: c @ M == c * s mod X^N + 1.

    M[j, i] = sign * s[(i - j) mod N], sign = -1 where i < j.
    s_centered int32 [..., N] -> int32 [..., N (j), N (i)]."""
    i = torch.arange(N, device=s_centered.device)[None, :]
    j = torch.arange(N, device=s_centered.device)[:, None]
    sgn = torch.where(i >= j, 1, -1).to(torch.int32)
    return sgn * s_centered[..., (i - j) % N]


def _block_conv(polys: torch.Tensor) -> torch.Tensor:
    """int32 [P, N] -> [N, P*N]: the polys' convolution matrices side by side."""
    P = polys.shape[0]
    return _conv_matrix(polys).permute(1, 0, 2).reshape(N, P * N)


def _wy_limbs_from_ahat(a_hat: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """A_hat [K, L, 256] -> the y -> w map as int8 limbs [3, L*N, K*N]:
    block (l, k) is the convolution matrix of A[k, l] = INTT(A_hat[k, l])."""
    K, L = p.K, p.L
    a_poly = center(ntt.invntt(a_hat, from_product=False))  # [K, L, N]
    conv = _conv_matrix(a_poly)  # [K, L, N(j), N(i)]
    w_mat = conv.permute(1, 2, 0, 3).reshape(L * N, K * N)
    return torch.stack(_to_limbs_i8(w_mat))


def build_operators(sk: torch.Tensor, p: DilithiumParams) -> KeyOperators:
    """Expand one unbatched sk uint8 [sk_bytes] into dense operators."""
    rho, key, tr, s1, s2, t0 = pack.unpack_sk(sk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    if not bool(ok_a):
        raise RuntimeError("ExpandA's candidate budget ran out for this key")
    wy_cat = torch.cat(list(_wy_limbs_from_ahat(a_hat, p)), dim=-1)
    # base-128 digits of t0: the convolution matrix negates entries, and a
    # base-256 digit of -128 would overflow int8 when negated
    lo = ((t0 + 64) % 128) - 64
    hi = (t0 - lo) >> 7
    c_cat = torch.cat([
        _block_conv(center(s1)), _block_conv(center(s2)),
        _block_conv(lo), _block_conv(hi),
    ], dim=-1).to(torch.int8)
    return KeyOperators(gemm_layout(wy_cat), gemm_layout(c_cat), key, tr)


def _mod_q_i32(x: torch.Tensor) -> torch.Tensor:
    """Exact x mod q -> int32 [0, q), for int32 x."""
    return torch.remainder(x, Q)


def _recombine(p0, p1, p2, p3, p4) -> torch.Tensor:
    """sum_k 2^(8k) P_k mod q for int32 P_k (|P_k| <= ~2.1e7), by Horner:
    acc' = P_k + 256 * centered(acc) stays within int32."""
    acc = _mod_q_i32(p4)
    for pk in (p3, p2, p1, p0):
        acc = _mod_q_i32(pk + (center(acc) << 8))
    return acc


def _dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N]. `torch._int_mm` on CUDA
    takes only M > 16, so fewer rows are zero-padded."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    return torch._int_mm(a, b)[:m]


def _apply_w(limbs, w_cat: torch.Tensor) -> torch.Tensor:
    """3 int8 limb planes [B, L*N] of a centered vector (y or z) -> w = the
    map's product int32 [B, K*N] canonical: 3 GEMMs against all 3 weight
    limbs side by side (w_cat [L*N, 3*K*N]), summed by power of 256 and
    recombined mod q."""
    kn = w_cat.shape[1] // 3
    prods = {}
    for i in range(3):
        p3 = _dot_i8(limbs[i], w_cat)  # int32 [B, 3*K*N]
        for j in range(3):
            pij = p3[:, j * kn:(j + 1) * kn]
            prods[i + j] = pij if i + j not in prods else prods[i + j] + pij
    return _recombine(*(prods[k] for k in range(5)))


def _y_centered(limbs: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """Centered y int32 [W, L, N] from its 3 int8 limb planes [3, W, L*N]
    (widened before the shifts)."""
    l32 = limbs.to(torch.int32)
    return (l32[0] + (l32[1] << 8) + (l32[2] << 16)).reshape(-1, p.L, N)


def _attempt_tail(c_cat: torch.Tensor, c: torch.Tensor, y_cent: torch.Tensor, w0: torch.Tensor,
                  w1: torch.Tensor, p: DilithiumParams):
    """The attempt after its challenge c int32 [W, 256]: cs1, cs2 and ct0
    from one int8 GEMM against c_cat, z, the hint and the norm checks ->
    (centered z int32 [W, L, N], h uint8 [W, K, N], reject bool [W])."""
    W = c.shape[0]
    L, K = p.L, p.K
    ln, kn = L * N, K * N
    prod = _dot_i8(center(c).to(torch.int8), c_cat)  # [W, (L+3K)*N]
    cs1 = prod[:, :ln].reshape(W, L, N)
    cs2 = prod[:, ln:ln + kn].reshape(W, K, N)
    ct0 = (prod[:, ln + kn:ln + 2 * kn] + (prod[:, ln + 2 * kn:] << 7)).reshape(W, K, N)

    zc = y_cent + cs1
    w0_cs2 = w0 - cs2
    h = rounding.make_hint(w0_cs2 + ct0, w1, p)
    reject = (
        rounding.norm_exceeds(zc, p.gamma1 - p.beta, dim=(-2, -1))
        | rounding.norm_exceeds(w0_cs2, p.gamma2 - p.beta, dim=(-2, -1))
        | rounding.norm_exceeds(ct0, p.gamma2, dim=(-2, -1))
        | (h.sum(dim=(-2, -1), dtype=torch.int32) > p.omega)
    )
    return zc, h, reject


def _sign_attempt_mxu(ops: KeyOperators, mu: torch.Tensor, rhoprime: torch.Tensor,
                      kappa: torch.Tensor, p: DilithiumParams):
    """One candidate per row: mu uint8 [W, 64], rhoprime uint8 [W, 64],
    kappa int32 [W] -> (c_tilde uint8 [W, 32], z int32 [W, L, 256]
    canonical, h uint8 [W, K, 256], accept bool [W])."""
    W = mu.shape[0]
    limbs = sampling.expand_mask_limbs(rhoprime, kappa, p)  # int8 [3, W, L*N]
    w = _apply_w(limbs, ops.wy_cat).reshape(W, p.K, N)
    w1, w0 = rounding.decompose(w, p)
    w1_packed = pack.pack_w1(w1, p).reshape(W, p.K * p.polyw1_packedbytes)
    c_tilde = keccak.shake256(torch.cat([mu, w1_packed], dim=-1), 32)
    c, ok_ball = sampling.sample_in_ball(c_tilde, p)
    zc, h, reject = _attempt_tail(ops.c_cat, c, _y_centered(limbs, p), w0, w1, p)
    return c_tilde, uncenter(zc), h, ~reject & ok_ball


def sign_stream_mxu(ops: KeyOperators, mu: torch.Tensor, p: DilithiumParams,
                    window: int | None = None, max_rounds: int = 8192,
                    rhoprime: torch.Tensor | None = None) -> scheme.SignResult:
    """Sign a queue mu uint8 [Q, 64] under one key with the elastic stream
    loop over W = min(window, Q) attempt slots; window None is the level's
    `scheme.default_window(p)`. Deterministic by default
    (rhoprime = SHAKE256(key || mu, 64)); pass uniformly random rhoprime
    uint8 [Q, 64] for randomized signing."""
    Q_ = mu.shape[0]

    def attempt(mu_s, rp_s, kappa_s, q_s):
        del q_s  # one key: the operators are slot-invariant
        return _sign_attempt_mxu(ops, mu_s, rp_s, kappa_s, p)

    with trace.span("mxu.sign_stream"):
        rhoprime = scheme._rhoprime(ops.key.expand(Q_, ops.key.shape[-1]), mu, rhoprime)
        return scheme._stream_loop(attempt, mu, rhoprime, p, scheme._slots(window, p, Q_), max_rounds)


class MxuSigner(nn.Module):
    """A one-key signing service: the key's operators as buffers, and
    forward(mu, rhoprime=None) -> SignResult over min(window, Q) attempt
    slots; window None is the level's `scheme.default_window(p)`.
    Move it with `.to(device)`."""

    def __init__(self, ops: KeyOperators, p: DilithiumParams,
                 window: int | None = None, max_rounds: int = 8192):
        super().__init__()
        self.p, self.window, self.max_rounds = p, window, max_rounds
        self.register_buffer("wy_cat", gemm_layout(ops.wy_cat))
        self.register_buffer("c_cat", gemm_layout(ops.c_cat))
        self.register_buffer("key", ops.key)
        self.register_buffer("tr", ops.tr)

    @property
    def operators(self) -> KeyOperators:
        return KeyOperators(gemm_layout(self.wy_cat), gemm_layout(self.c_cat), self.key, self.tr)

    def forward(self, mu: torch.Tensor, rhoprime: torch.Tensor | None = None) -> scheme.SignResult:
        return sign_stream_mxu(self.operators, mu, self.p, self.window,
                               self.max_rounds, rhoprime)


class VerifyOperators(NamedTuple):
    """Dense per-public-key verify operators (see the module docstring)."""
    wz_cat: torch.Tensor  # int8 [L*256, 3*K*256], column-major
    t1_cat: torch.Tensor  # int8 [256, 3*K*256], column-major
    tr: torch.Tensor  # uint8 [32]


def build_verify_operators(pk: torch.Tensor, p: DilithiumParams) -> VerifyOperators:
    """Expand one unbatched pk uint8 [pk_bytes] into dense verify
    operators. Raises when ExpandA's candidate budget runs out (the JAX
    package checks this only under DILITHIUM_DEBUG_CHECKS)."""
    rho, t1 = pack.unpack_pk(pk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    if not bool(ok_a):
        raise RuntimeError("ExpandA's candidate budget ran out for this key")
    wz_cat = torch.cat(list(_wy_limbs_from_ahat(a_hat, p)), dim=-1)
    # limbs of the convolution matrices of centered t1 << d, taken after
    # the negacyclic sign flip (as for the y -> w map)
    t1_cat = torch.cat(_to_limbs_i8(_block_conv(center(t1 << D))), dim=-1)
    tr = keccak.shake256(pk, TRBYTES)
    return VerifyOperators(gemm_layout(wz_cat), gemm_layout(t1_cat), tr)


def _z_times_a(vops: VerifyOperators, zc: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """A z int32 [B, K*N] canonical, from centered z [B, L, N]: z's int8
    limbs, 3 GEMMs against wz_cat and the recombine."""
    return _apply_w(_to_limbs_i8(zc.reshape(zc.shape[0], p.L * N)), vops.wz_cat)


def _c_times_t1(vops: VerifyOperators, c: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """c t1 2^d int32 [B, K*N] canonical, from c int32 [B, 256]: one int8
    GEMM against t1_cat. c has entries {0, +-1}: |c @ T1_j| <= tau * 128,
    so the limbs' direct sum fits int32."""
    kn = p.K * N
    prod = _dot_i8(center(c).to(torch.int8), vops.t1_cat)  # [B, 3*K*N]
    return _mod_q_i32(prod[:, :kn] + (prod[:, kn:2 * kn] << 8) + (prod[:, 2 * kn:] << 16))


def verify_mxu(vops: VerifyOperators, sig: torch.Tensor, mu: torch.Tensor,
               p: DilithiumParams) -> torch.Tensor:
    """Verify sig uint8 [B, sig_bytes], mu uint8 [B, 64] under one key's
    dense operators -> bool [B], the same answers as `scheme.verify`.
    SampleInBall's ok is discarded, as in the JAX package."""
    with trace.span("mxu.verify"):
        B = mu.shape[0]
        c_tilde, z, h, h_ok = pack.unpack_sig(sig, p)
        zc = center(z)
        z_ok = ~rounding.norm_exceeds(zc, p.gamma1 - p.beta, dim=(-2, -1))
        c, _ = sampling.sample_in_ball(c_tilde, p)

        w = sub_mod(_z_times_a(vops, zc, p), _c_times_t1(vops, c, p)).reshape(B, p.K, N)
        return scheme._verify_tail(w, h, c_tilde, mu, z_ok & h_ok, p)


class MxuVerifier(nn.Module):
    """A one-key verify service: the key's verify operators as buffers, and
    forward(sig, mu) -> bool [B]. Move it with `.to(device)`."""

    def __init__(self, vops: VerifyOperators, p: DilithiumParams):
        super().__init__()
        self.p = p
        self.register_buffer("wz_cat", gemm_layout(vops.wz_cat))
        self.register_buffer("t1_cat", gemm_layout(vops.t1_cat))
        self.register_buffer("tr", vops.tr)

    @property
    def operators(self) -> VerifyOperators:
        return VerifyOperators(gemm_layout(self.wz_cat), gemm_layout(self.t1_cat), self.tr)

    def forward(self, sig: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        return verify_mxu(self.operators, sig, mu, self.p)
