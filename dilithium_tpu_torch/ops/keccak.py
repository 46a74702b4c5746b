"""Batched SHAKE128/256 and SHA3-256/512 over fixed-length messages.

The port of `dilithium_tpu/ops/keccak.py`. Every sponge on the signing
path goes through `sponge`: a CUDA tensor runs kernel K1
(`csrc/sponge.cu`, one thread per message, state in registers), a CPU
tensor runs `sponge_plain`, a vectorised Keccak-f[1600] on int64 lanes.
The bare permutation, `keccak_f1600` / `keccak_f1600_planes`, runs
kernel K5 (`csrc/permute.cu`) on a CUDA tensor.
Messages are uint8 [..., msg_len] (all of one length); outputs are uint8
[..., out_bytes], or for the `*_words` forms int64 [..., out_words] with
word j = stream bytes 4j..4j+3 little-endian, in [0, 2^32).
"""

from __future__ import annotations

import math

import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.params import SHAKE128_RATE, SHAKE256_RATE

SHA3_256_RATE = 136
SHA3_512_RATE = 72

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# as signed int64 (torch has no uint64 arithmetic)
_RC_I64 = [c - (1 << 64) if c >= 1 << 63 else c for c in _RC]

# rho offsets for lane k = x + 5y
_RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_ROT = [_RHO[k % 5][k // 5] for k in range(25)]
# pi: lane (x, y) moves to (y, 2x + 3y); _PI_SRC[dest] = source lane
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
# chi: lane (x, y) ^= ~(x+1, y) & (x+2, y)
_CHI1 = [(k % 5 + 1) % 5 + 5 * (k // 5) for k in range(25)]
_CHI2 = [(k % 5 + 2) % 5 + 5 * (k // 5) for k in range(25)]


def _rotl(x: torch.Tensor, r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """64-bit rotate left of int64 lanes by r in [0, 63]; mask = 2^r - 1
    clears the sign bits the arithmetic right shift drags in."""
    return (x << r) | (((x >> (63 - r)) >> 1) & mask)


def keccak_f1600_plain(st: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on int64 lanes [B, 25] (lane k = x + 5y)."""
    dev = st.device
    rot = torch.tensor(_ROT, dtype=torch.int64, device=dev)
    rot_mask = (torch.ones_like(rot) << rot) - 1
    pi_src = torch.tensor(_PI_SRC, device=dev)
    chi1 = torch.tensor(_CHI1, device=dev)
    chi2 = torch.tensor(_CHI2, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    b = st.shape[0]
    for rc in _RC_I64:
        # theta
        s = st.view(b, 5, 5)  # [B, y, x]
        c = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3] ^ s[:, 4]  # [B, x]
        c_next = c.roll(-1, dims=1)
        d = c.roll(1, dims=1) ^ ((c_next << 1) | ((c_next >> 63) & one))
        st = (s ^ d[:, None, :]).reshape(b, 25)
        # rho + pi
        st = _rotl(st, rot, rot_mask)[:, pi_src]
        # chi + iota
        st = st ^ (~st[:, chi1] & st[:, chi2])
        st[:, 0] ^= rc
    return st


def _permute(st: torch.Tensor, batch: int, state_stride: int, lane_stride: int) -> torch.Tensor:
    st = st.contiguous()
    out = torch.empty_like(st)
    _kernels.launch("permute", st, st.data_ptr(), out.data_ptr(), batch, state_stride,
                    lane_stride)
    return out


def _check_lanes(st: torch.Tensor, lane_dim: int) -> None:
    if st.dtype != torch.int64 or st.dim() != 2 or st.shape[lane_dim] != 25:
        want = "[B, 25]" if lane_dim == 1 else "[25, B]"
        raise ValueError(f"expected int64 lanes {want}; got {st.dtype} {tuple(st.shape)}")


def keccak_f1600(st: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] per state on int64 lanes [B, 25] (lane k = x +
    5y): kernel K5 (`csrc/permute.cu`) on a CUDA tensor, the plain version
    on a CPU one."""
    _check_lanes(st, 1)
    if not _kernels.on_cuda(st):
        return keccak_f1600_plain(st)
    return _permute(st, st.shape[0], 25, 1)


def keccak_f1600_planes(planes: torch.Tensor) -> torch.Tensor:
    """The plane form of `keccak_f1600`: int64 [25, B], row k = lane k of
    every state (the counterpart of `keccak_pallas.f1600_folded`'s lane
    planes). K5 on a CUDA tensor, with coalesced lane loads."""
    _check_lanes(planes, 0)
    if not _kernels.on_cuda(planes):
        return keccak_f1600_plain(planes.t().contiguous()).t().contiguous()
    return _permute(planes, planes.shape[1], 1, planes.shape[1])


def _pad(data: torch.Tensor, rate: int, domain: int) -> torch.Tensor:
    """pad10*1: uint8 [B, n] -> uint8 [B, nblk * rate]."""
    b, n = data.shape
    nblk = n // rate + 1
    padded = torch.zeros((b, nblk * rate), dtype=torch.uint8, device=data.device)
    padded[:, :n] = data
    padded[:, n] ^= domain
    padded[:, -1] ^= 0x80
    return padded


def sponge_plain(data: torch.Tensor, out_bytes: int, rate: int, domain: int) -> torch.Tensor:
    """Plain version of kernel K1: uint8 [B, n] -> uint8 [B, out_bytes]."""
    b = data.shape[0]
    rate_w = rate // 8
    lanes = _pad(data, rate, domain).view(torch.int64).view(b, -1, rate_w)
    st = torch.zeros((b, 25), dtype=torch.int64, device=data.device)
    for blk in range(lanes.shape[1]):
        st[:, :rate_w] ^= lanes[:, blk]
        st = keccak_f1600_plain(st)
    outs = []
    for i in range(-(-out_bytes // rate)):
        if i:
            st = keccak_f1600_plain(st)
        outs.append(st[:, :rate_w].contiguous().view(torch.uint8))
    return torch.cat(outs, dim=1)[:, :out_bytes]


def sponge(data: torch.Tensor, out_bytes: int, rate: int, domain: int) -> torch.Tensor:
    """Sponge over a batch: uint8 [B, n] -> uint8 [B, out_bytes]; K1 on
    a CUDA tensor, the plain version on a CPU one."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"expected uint8 [B, n] messages; got {data.dtype} {tuple(data.shape)}")
    if not _kernels.on_cuda(data):
        return sponge_plain(data, out_bytes, rate, domain)
    if rate % 8 or not 8 <= rate <= SHAKE128_RATE:
        raise ValueError(f"rate must be a multiple of 8 in [8, {SHAKE128_RATE}]; got {rate}")
    data = data.contiguous()
    out = torch.empty((data.shape[0], out_bytes), dtype=torch.uint8, device=data.device)
    _kernels.launch(
        "sponge", data, data.data_ptr(), out.data_ptr(), data.shape[0], data.shape[1],
        out_bytes, rate, domain,
    )
    return out


def shake(data: torch.Tensor, out_bytes: int, rate: int, domain: int = 0x1F) -> torch.Tensor:
    """uint8 [..., n] -> uint8 [..., out_bytes]. rate 168 (SHAKE128) or 136
    (SHAKE256) with domain 0x1F; the SHA3 modes use domain 0x06."""
    batch = data.shape[:-1]
    out = sponge(data.reshape(math.prod(batch), data.shape[-1]), out_bytes, rate, domain)
    return out.reshape(batch + (out_bytes,))


def shake_words(data: torch.Tensor, out_words: int, rate: int) -> torch.Tensor:
    """uint8 [..., n] -> int64 [..., out_words]: the SHAKE stream as
    little-endian 32-bit words, each in [0, 2^32)."""
    by = shake(data, 4 * out_words, rate)
    return by.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sha3_256(data: torch.Tensor) -> torch.Tensor:
    return shake(data, 32, SHA3_256_RATE, domain=0x06)


def sha3_512(data: torch.Tensor) -> torch.Tensor:
    return shake(data, 64, SHA3_512_RATE, domain=0x06)


def shake128(data: torch.Tensor, out_bytes: int) -> torch.Tensor:
    return shake(data, out_bytes, SHAKE128_RATE)


def shake256(data: torch.Tensor, out_bytes: int) -> torch.Tensor:
    return shake(data, out_bytes, SHAKE256_RATE)


def shake128_words(data: torch.Tensor, out_words: int) -> torch.Tensor:
    return shake_words(data, out_words, SHAKE128_RATE)


def shake256_words(data: torch.Tensor, out_words: int) -> torch.Tensor:
    return shake_words(data, out_words, SHAKE256_RATE)
