"""A/B rig: SHAKE over plane-major words (K6) against K1's sponge.

The counterpart of the JAX package's `tools/xof_exp.py`. There the
question was where the batch-major transpose of the squeezed words runs
on the TPU. Here both sides write batch-major words, and the question is
how the sponge reads its input:

  A: `keccak.shake_words`, kernel K1, which gives each raw message row a
     warp (one state lane a thread) and pads inside the kernel;
  B: `xof_bm`: the `planes_for` prologue (pad10*1, 32-bit words, planes
     [n_in_words, B]) and kernel K6 (`csrc/sponge_planes.cu`), whose word
     loads are coalesced.

Both return int64 [..., out_words] words in [0, 2^32), equal to each other
and to hashlib. `bench_kernels` times them interleaved.
"""

from __future__ import annotations

import math

import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.ops import keccak

_MAX_RATE_W = 21  # SHAKE128: 168-byte rate, 21 lanes


def planes_for(data: torch.Tensor, rate: int) -> torch.Tensor:
    """SHAKE prologue: uint8 [B, n] -> int32 [n_in_words, B], the padded
    messages (pad10*1, domain 0x1F) as little-endian 32-bit words, plane w
    holding word w of every message. Word 2k / 2k + 1 of absorb block blk
    is plane blk * rate / 4 + 2k / 2k + 1. The TPU prologue's fold of the
    batch onto [B/128, 128] tiles is dropped: the batch is one axis."""
    return keccak._pad(data, rate, 0x1F).view(torch.int32).t().contiguous()


def _check_planes(planes: torch.Tensor, rate_w: int) -> None:
    if planes.dtype != torch.int32 or planes.dim() != 2:
        raise ValueError(f"expected int32 planes [n_in_words, B]; got {planes.dtype} {tuple(planes.shape)}")
    if not 1 <= rate_w <= _MAX_RATE_W or planes.shape[0] % (2 * rate_w) or planes.shape[0] == 0:
        raise ValueError(f"{planes.shape[0]} planes are not whole blocks of rate_w = {rate_w} lanes")


def shake_words_batchmajor_plain(planes: torch.Tensor, out_words: int, rate_w: int) -> torch.Tensor:
    """Plain version of K6: int32 planes [n_in_words, B] -> int32
    [B, out_words] (32-bit words as bit patterns)."""
    _check_planes(planes, rate_w)
    b = planes.shape[1]
    lanes = planes.t().contiguous().view(torch.int64)  # [B, n_in_words / 2], word 2k low
    st = torch.zeros((b, 25), dtype=torch.int64, device=planes.device)
    for blk in range(lanes.shape[1] // rate_w):
        st[:, :rate_w] ^= lanes[:, blk * rate_w:(blk + 1) * rate_w]
        st = keccak.keccak_f1600_plain(st)
    outs = []
    for i in range(math.ceil(out_words / (2 * rate_w))):
        if i:
            st = keccak.keccak_f1600_plain(st)
        outs.append(st[:, :rate_w].contiguous().view(torch.int32))
    return torch.cat(outs, dim=1)[:, :out_words].contiguous()


def shake_words_batchmajor(planes: torch.Tensor, out_words: int, rate_w: int) -> torch.Tensor:
    """Absorb the padded word planes and squeeze out_words words per
    message: int32 [n_in_words, B] -> int32 [B, out_words]. Kernel K6 on a
    CUDA tensor, the plain version on a CPU one."""
    if not _kernels.on_cuda(planes):
        return shake_words_batchmajor_plain(planes, out_words, rate_w)
    _check_planes(planes, rate_w)
    planes = planes.contiguous()
    n_in, b = planes.shape
    out = torch.empty((b, out_words), dtype=torch.int32, device=planes.device)
    _kernels.launch("sponge_planes", planes, planes.data_ptr(), out.data_ptr(), b, n_in,
                    out_words, rate_w)
    return out


def xof_bm(data: torch.Tensor, out_words: int, rate: int) -> torch.Tensor:
    """SHAKE through the plane prologue and K6, with the contract of
    `keccak.shake_words`: uint8 [..., n] -> int64 [..., out_words], each
    word in [0, 2^32). rate 168 (SHAKE128) or 136 (SHAKE256)."""
    batch = data.shape[:-1]
    flat = data.reshape(math.prod(batch), data.shape[-1])
    out = shake_words_batchmajor(planes_for(flat, rate), out_words, rate // 8)
    return (out.to(torch.int64) & 0xFFFFFFFF).reshape(batch + (out_words,))
