"""Peaks of one NVIDIA H100 SXM and the work of each kernel of the port.

A kernel launch's bound is the larger of its bytes (each input read once,
each output written once) over the memory bandwidth and its operations
over the matching peak; its roofline share is that bound over its device
time. The counts are the ones the port's on-card checks have used since
the kernels were brought up (`chip_smoke.py`'s phases 3 and 6), frozen
here so that a change to the program cannot change the yardstick.

Peaks, all at the card's full power limit of 700 W (a card set below it
runs slower and reads a lower share; the harness logs the limit):
- memory: 3.35 TB/s of HBM3, NVIDIA's data sheet (SXM);
- int8 tensor cores: 1979 TOP/s dense, NVIDIA's data sheet (SXM);
- 32-bit integer instructions: 132 SMs x 64 lanes x 1980 MHz (the SXM
  part's boost clock) = 16.727 T/s. This one is derived from the SM count
  and the clock, not taken from the data sheet, which gives no such
  figure.
"""

from __future__ import annotations

POWER_LIMIT_W = 700.0  # the power limit at which the peaks hold
MEM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ

# 32-bit instructions of one Keccak-f[1600] with 3-input logic (LOP3) and
# 64-bit rotates as two funnel shifts, per round: theta's column parities
# 20, its five rotates 10, its 25 lane updates 50, rho 48, chi 50, iota 2
PERM_OPS = 24 * 180
# a Shoup butterfly: 3 multiplies and 6 adds, subtracts and selects
BUTTERFLY_OPS = 9
SHAKE256_RATE = 136
COEFFS = 256


def sponge_work(batch: int, msg_len: int, out_bytes: int, rate: int):
    """(bytes, ops) of a sponge over [batch, msg_len] -> out_bytes (K1)."""
    perms = msg_len // rate + 1 + -(-out_bytes // rate) - 1
    return batch * (msg_len + out_bytes), batch * perms * PERM_OPS


def mask_limbs_work(w: int, l: int, z_bits: int):
    """(bytes, ops) of ExpandMask into int8 limbs for W slots of L
    polynomials (K2): rhoprime and kappa in, 3 limb planes out; one
    66-byte SHAKE256 absorb a polynomial."""
    return (w * (64 + 4 + 3 * l * COEFFS),
            w * l * sponge_work(1, 66, COEFFS * z_bits // 8, SHAKE256_RATE)[1])


def ball_work(batch: int, tau: int):
    """(bytes, ops) of SampleInBall (K3, K7) that every row needs at the
    least: its 8 sign bytes and one byte a take read, c (int32) and ok
    written; one op an output coefficient. A walk that rejects reads more,
    so this is a lower bound of the work."""
    return batch * (8 + tau) + batch * (COEFFS * 4 + 1), batch * COEFFS


def ball_stream_work(batch: int, nbytes: int):
    """(bytes, ops) of SampleInBall with its whole stream read."""
    return batch * (nbytes + COEFFS * 4 + 1), batch * COEFFS


def ntt_work(batch: int, inverse: bool):
    """(bytes, ops) of batch NTTs (K4): 8 x 128 butterflies, and the
    inverse's 256 scaling products (4 ops each)."""
    return batch * 2 * COEFFS * 4, batch * (8 * 128 * BUTTERFLY_OPS + (COEFFS * 4 if inverse else 0))


def permute_work(batch: int):
    """(bytes, ops) of batch Keccak-f[1600] permutations (K5)."""
    return batch * 400, batch * PERM_OPS


def sponge_planes_work(batch: int, planes: int, msg_len: int, out_words: int, rate: int):
    """(bytes, ops) of the plane-major sponge (K6): 32-bit planes in,
    words out."""
    return batch * (planes + out_words) * 4, sponge_work(batch, msg_len, 4 * out_words, rate)[1]


def int8_gemm_work(m: int, k: int, n: int):
    """(bytes, ops) of int8 [m, k] @ int8 [k, n] -> int32 [m, n]: a
    multiply-add is two operations."""
    return m * k + k * n + 4 * m * n, 2 * m * k * n


def bound_s(work, ops_per_s: float = INT32_OPS_PER_S) -> float:
    """Seconds the card needs at least for (bytes, ops)."""
    nbytes, ops = work
    return max(nbytes / MEM_BYTES_PER_S, ops / ops_per_s)


def launch_work(key: tuple):
    """(bytes, ops) of one launch of the port's signing-path kernels, from
    its shape key (the kernel's name and the scalar arguments of its C
    entry point, in order); None for a kernel not counted here."""
    kernel, *args = key
    if kernel == "sponge":
        batch, msg_len, out_bytes, rate, _domain = args
        return sponge_work(batch, msg_len, out_bytes, rate)
    if kernel == "mask_limbs":
        w, l, z_bits, _gamma1 = args
        return mask_limbs_work(w, l, z_bits)
    if kernel == "ball":
        batch, tau, _nbytes = args
        return ball_work(batch, tau)
    if kernel == "ntt":
        batch, inverse, _scale, _shoup = args
        return ntt_work(batch, bool(inverse))
    return None
