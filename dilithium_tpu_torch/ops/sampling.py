"""ExpandA / ExpandS / ExpandMask / SampleInBall.

The port of the signing-path part of `dilithium_tpu/ops/sampling.py`. The
rejection samplers draw a fixed number of XOF blocks and keep the accepted
candidates in order with one prefix-sum + scatter compaction (`_compact`)
over an explicit candidate budget; `ok` reports whether the budget held,
with the JAX package's rules, so values agree wherever `ok` holds and the
flags agree everywhere.

Two kernels sit here: `expand_mask_limbs` runs K2 (`csrc/mask_limbs.cu`)
and `sample_in_ball` runs K3 (`csrc/ball.cu`) on CUDA tensors; on CPU
tensors they run `mask_limbs_plain` and `sample_in_ball_plain`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.params import N, Q, SHAKE128_RATE, SHAKE256_RATE, DilithiumParams
from dilithium_tpu_torch.ops import keccak
from dilithium_tpu_torch.ops.pack import unpack_bits_w
from dilithium_tpu_torch.ops.reduce import center, uncenter


def _le16(n: torch.Tensor) -> torch.Tensor:
    """int [...] -> uint8 [..., 2]: the low 16 bits, little-endian."""
    n = n.to(torch.int64)
    return torch.stack([n & 0xFF, (n >> 8) & 0xFF], dim=-1).to(torch.uint8)


def _compact(cand: torch.Tensor, accept: torch.Tensor, n_out: int,
             budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first n_out accepted candidates, in order, looking only at
    the first `budget` candidates. ok is False when fewer than n_out of
    those are accepted; the output then holds zeros past the last one."""
    cand, accept = cand[..., :budget], accept[..., :budget]
    acc = accept.to(torch.int64)
    rank = torch.cumsum(acc, dim=-1) - acc
    slot = torch.where(accept & (rank < n_out), rank, n_out)
    out = torch.zeros(cand.shape[:-1] + (n_out + 1,), dtype=cand.dtype, device=cand.device)
    out.scatter_(-1, slot, torch.where(slot < n_out, cand, 0))
    return out[..., :n_out], acc.sum(dim=-1) >= n_out


def expand_a(rho: torch.Tensor, p: DilithiumParams,
             max_skips: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """ExpandA: rho uint8 [..., 32] -> (A_hat int32 [..., K, L, 256], ok).

    SHAKE128(rho || le16((i << 8) + j)), 5 blocks; 3-byte candidates masked
    to 23 bits, accepted if < q. ok is False when the 256th accept lies
    beyond candidate 256 + max_skips (8 in keygen, 12 elsewhere)."""
    batch = rho.shape[:-1]
    K, L = p.K, p.L
    nonces = torch.tensor([(i << 8) + j for i in range(K) for j in range(L)], device=rho.device)
    msgs = torch.cat([
        rho.unsqueeze(-2).expand(batch + (K * L, 32)),
        _le16(nonces).expand(batch + (K * L, 2)),
    ], dim=-1)
    words = keccak.shake128_words(msgs, p.uniform_blocks * SHAKE128_RATE // 4)
    cand = unpack_bits_w(words, 24) & 0x7FFFFF
    out, ok = _compact(cand, cand < Q, N, N + max_skips)
    return out.to(torch.int32).reshape(batch + (K, L, N)), ok.reshape(batch + (K * L,)).all(dim=-1)


def expand_s(sigma: torch.Tensor, nonce_base: int, count: int,
             p: DilithiumParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """ExpandS: sigma uint8 [..., 64] -> (polys int32 [..., count, 256]
    canonical, ok) for nonces nonce_base .. nonce_base + count - 1.

    4-bit candidates, low nibble first; eta 2 keeps t < 15 -> 2 - t mod 5,
    eta 4 keeps t < 9 -> 4 - t. The budget is the 8-sigma window
    T = ceil(256/p + 8 sqrt(256 (1-p))/p) + 2, p = 15/16 or 9/16."""
    batch = sigma.shape[:-1]
    nonces = torch.arange(nonce_base, nonce_base + count, device=sigma.device)
    msgs = torch.cat([
        sigma.unsqueeze(-2).expand(batch + (count, 64)),
        _le16(nonces).expand(batch + (count, 2)),
    ], dim=-1)
    words = keccak.shake256_words(msgs, p.eta_blocks * SHAKE256_RATE // 4)
    nib = unpack_bits_w(words, 4)
    keep, p_accept = (15, 15 / 16) if p.eta == 2 else (9, 9 / 16)
    budget = int(math.ceil(
        N / p_accept + 8.0 * math.sqrt(N * (1.0 - p_accept)) / p_accept
    )) + 2
    out, ok = _compact(nib, nib < keep, N, budget)
    vals = 2 - out % 5 if p.eta == 2 else 4 - out
    return uncenter(vals), ok.all(dim=-1)


def expand_mask(rhoprime: torch.Tensor, kappa: torch.Tensor,
                p: DilithiumParams) -> torch.Tensor:
    """ExpandMask: rhoprime uint8 [..., 64], kappa int [...] -> y int32
    [..., L, 256] canonical; poly l uses nonce kappa + l and the
    gamma1_bits-bit slices r of its SHAKE256 stream map to gamma1 - r."""
    batch = rhoprime.shape[:-1]
    L = p.L
    nonces = kappa.to(torch.int64).unsqueeze(-1) + torch.arange(L, device=kappa.device)
    msgs = torch.cat([rhoprime.unsqueeze(-2).expand(batch + (L, 64)), _le16(nonces)], dim=-1)
    words = keccak.shake256_words(msgs, p.polyz_packedbytes // 4)
    r = unpack_bits_w(words, p.gamma1_bits)
    return uncenter(p.gamma1 - r)


def _limbs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centered int32 -> balanced base-256 digits (int32), x = d0 + 256 d1
    + 65536 d2 with each d in [-128, 127]."""
    d0 = ((x + 128) & 255) - 128
    x1 = (x - d0) >> 8
    d1 = ((x1 + 128) & 255) - 128
    return d0, d1, (x1 - d1) >> 8


def mask_limbs_plain(rhoprime: torch.Tensor, kappa: torch.Tensor,
                     p: DilithiumParams) -> torch.Tensor:
    """Plain version of K2: int8 [3, W, L*256] limbs of centered y."""
    W = rhoprime.shape[0]
    y = center(expand_mask(rhoprime, kappa, p)).reshape(W, p.L * N)
    return torch.stack(_limbs(y)).to(torch.int8)


def expand_mask_limbs(rhoprime: torch.Tensor, kappa: torch.Tensor,
                      p: DilithiumParams) -> torch.Tensor:
    """rhoprime uint8 [W, 64], kappa int32 [W] -> int8 [3, W, L*256]:
    out[d, b, l*256 + j] is digit d of centered coefficient j of mask poly l
    of message b (the JAX function's limbs[d, j, l, b]). K2 on CUDA."""
    if not _kernels.on_cuda(rhoprime):
        return mask_limbs_plain(rhoprime, kappa, p)
    W = rhoprime.shape[0]
    rhoprime = rhoprime.contiguous()
    kappa = kappa.to(torch.int32).contiguous()
    if rhoprime.shape != (W, 64) or rhoprime.dtype != torch.uint8 or kappa.shape != (W,):
        raise ValueError("expected rhoprime uint8 [W, 64] and kappa [W]")
    if p.gamma1_bits not in (18, 20):
        raise ValueError(f"mask kernel takes 18- or 20-bit y, not {p.gamma1_bits}")
    out = torch.empty((3, W, p.L * N), dtype=torch.int8, device=rhoprime.device)
    _kernels.launch(
        "mask_limbs", rhoprime, rhoprime.data_ptr(), kappa.data_ptr(), out.data_ptr(),
        W, p.L, p.gamma1_bits, p.gamma1,
    )
    return out


def ball_positions(stream: torch.Tensor, tau: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk of SampleInBall: stream uint8 [B, nbytes] -> (j int64
    [B, tau], neg int64 [B, tau] in {0, 1}, ok bool [B]).

    Bytes 0..7 are 64 sign bits (neg[:, t] = bit t); each later byte j is
    taken for step i = 256 - tau + cnt iff j <= i. Steps the stream did not
    fill get j = 0 (ok is False then)."""
    B, nbytes = stream.shape
    dev = stream.device
    by = stream.to(torch.int64)
    signs = (by[:, :8, None] >> torch.arange(8, device=dev)) & 1  # [B, 8, 8]
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    j_buf = torch.zeros((B, tau + 1), dtype=torch.int64, device=dev)  # column tau collects the rest
    for t in range(8, nbytes):
        b = by[:, t]
        take = (b <= N - tau + cnt) & (cnt < tau)
        j_buf.scatter_(1, torch.where(take, cnt, tau)[:, None], b[:, None])
        cnt = cnt + take.to(torch.int64)
    return j_buf[:, :tau], signs.reshape(B, 64)[:, :tau], cnt >= tau


def sample_in_ball_plain(stream: torch.Tensor, tau: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: stream uint8 [B, nbytes] -> (c int32 [B, 256]
    in {0, 1, q-1}, ok bool [B]): the walk of `ball_positions`, then tau
    Fisher-Yates steps c[i] = c[j], c[j] = +-1 by sign bit t."""
    j_pos, neg, ok = ball_positions(stream, tau)
    sval = 1 - 2 * neg
    c = torch.zeros((stream.shape[0], N), dtype=torch.int64, device=stream.device)
    for t in range(tau):
        j = j_pos[:, t:t + 1]
        c[:, N - tau + t] = c.gather(1, j)[:, 0]
        c.scatter_(1, j, sval[:, t:t + 1])
    return uncenter(c), ok


def sample_in_ball_stream(stream: torch.Tensor, tau: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SampleInBall from the stream bytes uint8 [B, nbytes]: K3 on CUDA,
    `sample_in_ball_plain` on the CPU."""
    if not _kernels.on_cuda(stream):
        return sample_in_ball_plain(stream, tau)
    if stream.dtype != torch.uint8 or stream.dim() != 2 or stream.shape[1] < 8:
        raise ValueError("expected a uint8 [B, nbytes] stream with nbytes >= 8")
    if not 0 < tau <= 64:
        raise ValueError(f"tau must be in [1, 64] (one sign bit per step); got {tau}")
    stream = stream.contiguous()
    B, nbytes = stream.shape
    c = torch.empty((B, N), dtype=torch.int32, device=stream.device)
    ok = torch.empty((B,), dtype=torch.bool, device=stream.device)  # K3 stores 0 or 1 a byte
    _kernels.launch(
        "ball", stream, stream.data_ptr(), c.data_ptr(), ok.data_ptr(), B, tau, nbytes,
    )
    return c, ok


def sample_in_ball(c_tilde: torch.Tensor, p: DilithiumParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """SampleInBall: c_tilde uint8 [B, 32] -> (c int32 [B, 256] canonical
    {0, 1, q-1}, ok bool [B]). The stream is SHAKE256(c_tilde), 272 bytes
    (K1); the walk and swaps run in K3 on CUDA."""
    return sample_in_ball_stream(keccak.shake256(c_tilde, p.ball_blocks * SHAKE256_RATE), p.tau)
