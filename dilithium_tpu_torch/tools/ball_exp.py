"""A/B rig: SampleInBall on bit planes (K7) against K3.

The counterpart of the JAX package's `tools/ball_exp.py`, whose "V0" is
the shipped kernel (here K3, `ops.sampling.sample_in_ball_stream`) and
whose "V1" holds the challenge polynomial c as two 256-bit planes, nz
(c[r] != 0) and sg (c[r] = -1). `sample_in_ball_v1` runs V1 as kernel K7
(`csrc/ball_bitplane.cu`) on a CUDA tensor and
`sample_in_ball_v1_plain`, the same bit-plane algorithm in PyTorch, on a
CPU one. Both hold each plane as eight 32-bit words, coefficient r at bit
r & 31 of word r >> 5: the plain version in int64 [B, 8] tensors, K7 as
eight (nz, sg) word pairs a message in shared memory. Both have K3's
contract; `bench_kernels` times K3 and K7 interleaved.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.ops.sampling import ball_positions
from dilithium_tpu_torch.params import N, Q


def sample_in_ball_v1_plain(stream: torch.Tensor, tau: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: stream uint8 [B, nbytes] -> (c int32 [B, 256]
    in {0, 1, q-1}, ok bool [B]).

    The walk is K3's (`ball_positions`); the tau swaps then run on nz / sg
    as [B, 8] 32-bit words (held in int64): c[i] = c[j] copies bit j of
    both planes to bit i = 256 - tau + t, then c[j] = +-1 sets nz bit j
    and sg bit j to sign bit t. c is built from the planes at the end."""
    j_pos, neg, ok = ball_positions(stream, tau)
    B = stream.shape[0]
    dev = stream.device
    rows = torch.arange(B, device=dev)
    nz = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    sg = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    for t in range(tau):
        j = j_pos[:, t]
        jw, jb = j >> 5, j & 31
        nz_j = (nz[rows, jw] >> jb) & 1
        sg_j = (sg[rows, jw] >> jb) & 1
        iw, ib = (N - tau + t) >> 5, (N - tau + t) & 31
        nz[:, iw] = (nz[:, iw] & ~(1 << ib)) | (nz_j << ib)
        sg[:, iw] = (sg[:, iw] & ~(1 << ib)) | (sg_j << ib)
        m = torch.ones_like(jb) << jb
        nz[rows, jw] = nz[rows, jw] | m
        sg[rows, jw] = (sg[rows, jw] & ~m) | (neg[:, t] << jb)
    bits = torch.arange(32, device=dev)
    nz_b = ((nz[:, :, None] >> bits) & 1).reshape(B, N)
    sg_b = ((sg[:, :, None] >> bits) & 1).reshape(B, N)
    c = nz_b * torch.where(sg_b == 1, Q - 1, 1)
    return c.to(torch.int32), ok


def sample_in_ball_v1(stream: torch.Tensor, tau: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SampleInBall from the stream bytes uint8 [B, nbytes] on bit planes:
    K7 on a CUDA tensor, `sample_in_ball_v1_plain` on a CPU one."""
    if not _kernels.on_cuda(stream):
        return sample_in_ball_v1_plain(stream, tau)
    if stream.dtype != torch.uint8 or stream.dim() != 2 or stream.shape[1] < 8:
        raise ValueError("expected a uint8 [B, nbytes] stream with nbytes >= 8")
    if not 0 < tau <= 64:
        raise ValueError(f"tau must be in [1, 64] (one sign bit per step); got {tau}")
    stream = stream.contiguous()
    B, nbytes = stream.shape
    c = torch.empty((B, N), dtype=torch.int32, device=stream.device)
    ok = torch.empty((B,), dtype=torch.bool, device=stream.device)  # K7 writes 0 or 1 a byte
    _kernels.launch("ball_bitplane", stream, stream.data_ptr(), c.data_ptr(), ok.data_ptr(),
                    B, tau, nbytes)
    return c, ok
