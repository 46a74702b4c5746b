"""Bit-pack / unpack codecs: keys, w1 and signatures.

The port of `dilithium_tpu/ops/pack.py`: the signing path's packers and
the verify path's unpackers, with the hint decoder's canonicity checks.
Byte order is the spec's little-endian bitstream (first coefficient in the
low bits of the first byte). Values are packed per group of lcm(8, bits)
bits with a few shifted ORs per output byte, on int64 so no shift
overflows.
"""

from __future__ import annotations

from math import gcd

import torch

from dilithium_tpu_torch.params import (
    D, N, POLYT0_PACKEDBYTES, POLYT1_PACKEDBYTES, SEEDBYTES, TRBYTES,
    DilithiumParams,
)
from dilithium_tpu_torch.ops.reduce import center, uncenter


def _lcm(a: int, b: int) -> int:
    return a * b // gcd(a, b)


def pack_bits(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """int [..., n] (each < 2^bits) -> uint8 [..., n*bits/8]."""
    n = vals.shape[-1]
    period = _lcm(8, bits)
    g, bg = period // bits, period // 8  # values / bytes per group
    if (n * bits) % 8 or n % g:
        raise ValueError(f"cannot pack {n} values of {bits} bits")
    v = vals.to(torch.int64).reshape(vals.shape[:-1] + (n // g, g))
    out = []
    for k in range(bg):
        acc = None
        for i in range(g):
            sh = 8 * k - bits * i
            if bits * i >= 8 * k + 8 or bits * (i + 1) <= 8 * k:
                continue
            term = v[..., i] >> sh if sh >= 0 else v[..., i] << -sh
            acc = term if acc is None else acc | term
        out.append((acc & 0xFF).to(torch.uint8))
    return torch.stack(out, dim=-1).reshape(vals.shape[:-1] + (n * bits // 8,))


def unpack_bits(data: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 [..., nbytes] -> int64 [..., nbytes*8/bits]."""
    nbytes = data.shape[-1]
    period = _lcm(8, bits)
    g, bg = period // bits, period // 8
    if nbytes % bg:
        raise ValueError(f"cannot unpack {nbytes} bytes into {bits}-bit values")
    b = data.to(torch.int64).reshape(data.shape[:-1] + (nbytes // bg, bg))
    vals = []
    for i in range(g):
        acc = None
        for k in range(bg):
            if 8 * k + 8 <= bits * i or 8 * k >= bits * (i + 1):
                continue
            sh = 8 * k - bits * i
            term = b[..., k] << sh if sh >= 0 else b[..., k] >> -sh
            acc = term if acc is None else acc | term
        vals.append(acc & ((1 << bits) - 1))
    return torch.stack(vals, dim=-1).reshape(data.shape[:-1] + (nbytes * 8 // bits,))


def unpack_bits_w(words: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 [..., nwords] 32-bit LE words -> int64 [..., nwords*32/bits]."""
    nwords = words.shape[-1]
    period = _lcm(32, bits)
    g, wg = period // bits, period // 32
    if nwords % wg:
        raise ValueError(f"cannot unpack {nwords} words into {bits}-bit values")
    w = words.reshape(words.shape[:-1] + (nwords // wg, wg))
    vals = []
    for i in range(g):
        k, s = divmod(bits * i, 32)
        acc = w[..., k] >> s
        if s + bits > 32:
            acc = acc | (w[..., k + 1] << (32 - s))
        vals.append(acc & ((1 << bits) - 1))
    return torch.stack(vals, dim=-1).reshape(words.shape[:-1] + (nwords * 32 // bits,))


# ---- per-poly codecs (last axis = 256 coefficients) ----

def pack_eta(s: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """s canonical, centered value in [-eta, eta]."""
    return pack_bits(p.eta - center(s), p.eta_bits)


def unpack_eta(b: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    return uncenter(p.eta - unpack_bits(b, p.eta_bits))


def pack_t1(t1: torch.Tensor) -> torch.Tensor:
    return pack_bits(t1, 10)


def unpack_t1(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 320] -> t1 int32 [..., 256] in [0, 1023]."""
    return unpack_bits(b, 10).to(torch.int32)


def pack_t0(t0: torch.Tensor) -> torch.Tensor:
    """t0 centered in (-2^12, 2^12]."""
    return pack_bits((1 << (D - 1)) - t0.to(torch.int64), 13)


def unpack_t0(b: torch.Tensor) -> torch.Tensor:
    return ((1 << (D - 1)) - unpack_bits(b, 13)).to(torch.int32)


def pack_z(z: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """z canonical, centered value in (-gamma1, gamma1]."""
    return pack_bits(p.gamma1 - center(z), p.gamma1_bits)


def unpack_z(b: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """uint8 [..., polyz_packedbytes] -> z int32 [..., 256] canonical: each
    gamma1_bits-bit value v decodes to gamma1 - v, centered value in
    (-gamma1, gamma1], so any bytes decode."""
    return uncenter(p.gamma1 - unpack_bits(b, p.gamma1_bits))


def pack_w1(w1: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    return pack_bits(w1, p.w1_bits)


def pack_hints(h: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """h 0/1 [..., K, 256] -> uint8 [..., omega + K]: the ascending
    positions of set bits of poly 0, 1, ..., zero-padded to omega, then the
    cumulative count through each poly. Bits ranked omega and beyond are
    dropped (the signer rejects weight above omega)."""
    batch = h.shape[:-2]
    hf = h.reshape(batch + (p.K * N,)).to(torch.int64)
    rank = torch.cumsum(hf, dim=-1) - hf
    slot = torch.where((hf == 1) & (rank < p.omega), rank, p.omega)
    pos = torch.arange(p.K * N, device=h.device).remainder(N).expand_as(hf)
    out = torch.zeros(batch + (p.omega + 1,), dtype=torch.int64, device=h.device)
    out.scatter_(-1, slot, torch.where(slot < p.omega, pos, 0))
    counts = torch.cumsum(hf.reshape(batch + (p.K, N)).sum(dim=-1), dim=-1)
    return (torch.cat([out[..., :p.omega], counts], dim=-1) & 0xFF).to(torch.uint8)


def unpack_hints(b: torch.Tensor, p: DilithiumParams):
    """uint8 [..., omega + K] -> (h uint8 [..., K, 256] 0/1, ok bool [...]).

    ok holds for a canonical encoding only: cumulative counts
    non-decreasing and each <= omega; positions strictly increasing within
    a polynomial; zeros after the last hint. The bitmap is the JAX
    function's on every input, malformed ones included: slot s belongs to
    polynomial k = #(counts <= s) (whether or not the counts are
    monotone), and slots with k = K set nothing."""
    K, omega = p.K, p.omega
    batch = b.shape[:-1]
    data = b.to(torch.int64)
    ends = data[..., omega:]  # [..., K] cumulative counts
    prev = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
    ok = (ends >= prev).all(dim=-1) & (ends <= omega).all(dim=-1)

    slots = torch.arange(omega, device=b.device)
    pos = data[..., :omega]  # [..., omega]
    poly_of_slot = (slots[:, None] >= ends[..., None, :]).sum(dim=-1)  # [..., omega]
    active = poly_of_slot < K
    same_poly = torch.cat([torch.zeros_like(active[..., :1]),
                           poly_of_slot[..., 1:] == poly_of_slot[..., :-1]], dim=-1)
    increasing = torch.cat([torch.ones_like(active[..., :1]), pos[..., 1:] > pos[..., :-1]], dim=-1)
    ok = ok & (increasing | ~(active & same_poly)).all(dim=-1)
    ok = ok & ((pos == 0) | active).all(dim=-1)

    # column K*N takes the inactive slots and is dropped
    flat_idx = torch.where(active, poly_of_slot * N + pos, K * N)
    bitmap = torch.zeros(batch + (K * N + 1,), dtype=torch.uint8, device=b.device)
    bitmap.scatter_(-1, flat_idx, 1)
    return bitmap[..., :K * N].reshape(batch + (K, N)), ok


# ---- key / signature containers ----

def pack_pk(rho: torch.Tensor, t1: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """rho uint8 [..., 32], t1 [..., K, 256] -> uint8 [..., pk_bytes]."""
    t1b = pack_t1(t1).reshape(t1.shape[:-2] + (p.K * POLYT1_PACKEDBYTES,))
    return torch.cat([rho, t1b], dim=-1)


def unpack_pk(pk: torch.Tensor, p: DilithiumParams):
    """uint8 [..., pk_bytes] -> (rho uint8 [..., 32], t1 int32 [..., K, 256])."""
    t1b = pk[..., SEEDBYTES:].reshape(pk.shape[:-1] + (p.K, POLYT1_PACKEDBYTES))
    return pk[..., :SEEDBYTES], unpack_t1(t1b)


def pack_sk(rho, key, tr, s1, s2, t0, p: DilithiumParams) -> torch.Tensor:
    """Components -> uint8 [..., sk_bytes]. s1/s2 canonical, t0 centered."""
    batch = rho.shape[:-1]
    s1b = pack_eta(s1, p).reshape(batch + (p.L * p.polyeta_packedbytes,))
    s2b = pack_eta(s2, p).reshape(batch + (p.K * p.polyeta_packedbytes,))
    t0b = pack_t0(t0).reshape(batch + (p.K * POLYT0_PACKEDBYTES,))
    return torch.cat([rho, key, tr, s1b, s2b, t0b], dim=-1)


def unpack_sk(sk: torch.Tensor, p: DilithiumParams):
    """uint8 [..., sk_bytes] -> (rho, key, tr, s1, s2 canonical, t0 centered)."""
    batch = sk.shape[:-1]
    rho, key, tr, rest = torch.split(
        sk, [SEEDBYTES, SEEDBYTES, TRBYTES, sk.shape[-1] - 2 * SEEDBYTES - TRBYTES], dim=-1
    )
    eb = p.polyeta_packedbytes
    s1b, s2b, t0b = torch.split(rest, [p.L * eb, p.K * eb, p.K * POLYT0_PACKEDBYTES], dim=-1)
    s1 = unpack_eta(s1b.reshape(batch + (p.L, eb)), p)
    s2 = unpack_eta(s2b.reshape(batch + (p.K, eb)), p)
    t0 = unpack_t0(t0b.reshape(batch + (p.K, POLYT0_PACKEDBYTES)))
    return rho, key, tr, s1, s2, t0


def pack_sig(c_tilde, z, h, p: DilithiumParams) -> torch.Tensor:
    """c_tilde uint8 [..., 32], z canonical [..., L, 256], h 0/1 [..., K, 256]."""
    batch = c_tilde.shape[:-1]
    zb = pack_z(z, p).reshape(batch + (p.L * p.polyz_packedbytes,))
    return torch.cat([c_tilde, zb, pack_hints(h, p)], dim=-1)


def unpack_sig(sig: torch.Tensor, p: DilithiumParams):
    """uint8 [..., sig_bytes] -> (c_tilde uint8 [..., 32], z int32
    [..., L, 256] canonical, h uint8 [..., K, 256] 0/1, ok bool [...]: the
    hint block is canonical)."""
    batch = sig.shape[:-1]
    nz = p.L * p.polyz_packedbytes
    z = unpack_z(sig[..., SEEDBYTES:SEEDBYTES + nz].reshape(batch + (p.L, p.polyz_packedbytes)), p)
    h, ok = unpack_hints(sig[..., SEEDBYTES + nz:], p)
    return sig[..., :SEEDBYTES], z, h, ok
