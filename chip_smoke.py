#!/usr/bin/env python3
"""Drive the PyTorch port's Dilithium signing and verify paths, its bytes
API and CLI, its kernel micro-bench and its measurement entry points on
one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the last
line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of dilithium_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, bit-equal,
     at the shapes the Dilithium-3 main path gives it and at edge shapes
     (ragged batches, message and output lengths at and off the rate and
     the 16-byte grain, the three rates, levels 2 and 5, the nonce's
     16-bit wrap; for K3 levels 2, 3 and 5 at B = 1, 33, 768, 769 and
     16384 with the stress rows of `tools/ball_edges.py`, no-take rows, a
     136-byte stream and unaligned rows; for K4 batches 1, 129, 513 and
     65536, all-zero and all-(q-1) inputs and both inverse scales through
     both of its kernels; the verify path's shapes at 16384 signatures:
     K1 on [16384, 32] -> 272 and [16384, 832] -> 32 bytes, K4 forward on
     [81920, 256] and inverse on [98304, 256]; the generic signers'
     shapes of a stream round and of a lockstep round at B = 16384,
     A = 4: K1's ExpandMask [3840, 66] and [327680, 66] -> 640 bytes,
     c_tilde [65536, 832] -> 32 and the ball stream [65536, 32] -> 272,
     K3 at B = 65536, K4 forward [327680, 256] and inverse [393216, 256];
     phase 8b's key set-up at 256 and 16384 keys: K1's seedbuf, ExpandA,
     ExpandS and tr sponges, K4 forward on the K and L polynomials a key
     and inverse on the K);
     each row with the median CUDA-event time of one call (`ms`, host
     time included at small shapes), the device-only time of one call
     (`device_ms`, `bench_kernels.device_ms`) and its bound;
     then the device guard: with two or more devices, K1-K4 and a small
     MxuVerifier on cuda:1 while cuda:0 is current, against their plain
     versions and the oracle (with one device a line says it did not run);
  4. a small slice (Dilithium-2, Q = 64, W = 32) on the card against the
     port's plain path on the CPU: equal keys, operators and signatures;
     then verify at levels 2 and 5: an oracle key, 64 signatures and
     corrupted rows of every class of `tools/verify_cases.py`, through
     verify_mxu, verify_expanded and verify on the card and on the CPU,
     all equal to oracle.verify;
  5. the main path: Dilithium-3, one key from a fixed seed, keygen ->
     build_operators -> MxuSigner over Q = 16384 mu at W = 768; every
     kernel must have launched, every signature must be ok and verify under
     the C++ oracle, and 512 must equal the oracle's signatures and
     attempts. Prints signs/s over timed runs after a warm-up run, then
     one more run under torch.profiler (CUDA activity): device time per
     round of K1, K2, K3, K4, the int8 GEMMs and the rest, and the
     device's busy share of that run;
  6. the kernel-bench path: K5 (permutation), K6 (plane-major sponge) and
     K7 (bit-plane SampleInBall) against their plain versions, bit-equal:
     K6 at its primary shape and at a ragged batch (20483), SHAKE128's 21
     lanes ([1000, 34 B] -> 210 words), a 7-block absorb (832 B -> 8),
     1 and 37 output words; K6 (with and without the `planes_for`
     prologue) against K1 at the port's shapes ([3840, 66] and
     [327680, 66] -> 160 words, [16384, 832] -> 8, [491520, 34] -> 210 at
     SHAKE128), bit-equal, then timed in turns; K7 against its plain
     version and K3 at levels 2, 3 and 5, B = 768, 16384, 65536 and 16421,
     with the stress rows of `tools/ball_edges.py`, timed in turns with
     K3; one line gives every A/B's answer; then
     `dilithium_tpu_torch.bench_kernels` at full width, counted: K5, K6
     and K7 must have launched;
  7. the verify path at full width: Dilithium-3, phase 5's key and its
     16384 signatures plus corrupted rows of every class; MxuVerifier
     (verify_mxu) and expand_pk + verify_expanded on every row, verify
     (A expanded per lane) on the first 512 and the corrupted rows, each
     equal to oracle.verify, counted: K1, K3 and K4 must have launched.
     Prints verifies/s of verify_mxu and verify_expanded (median of 3
     timed runs after a warm-up run), the one-time cost of
     build_verify_operators and expand_pk, each verifier's peak memory,
     and the device breakdown of one profiled verify_mxu call (K1, K3,
     K4, the int8 GEMMs and the rest) with its busy share.
  8. the bytes API and the generic signers. 8a, the gate, at levels 2, 3
     and 5 against the C++ oracle: `api.keygen` on 8 seeds; 64 messages of
     0-300 bytes signed by `api.sign`, `Signer` ("mxu" and "batch") and
     `MultiSigner` (8 keys), equal to `oracle.sign` in bytes, and the
     scheme calls beneath them in bytes and attempts; randomized
     signatures accepted by `oracle.verify` and unlike the deterministic
     ones; `api.verify` and `Verifier` ("mxu" and "batch") on valid rows,
     every corruption class of `tools/verify_cases.py` and a short
     signature, equal to `oracle.verify`; each `Verifier` again over
     batches of 8, 3, 12 and 8 pairs (its staging buffers grown, reused
     in part and grown again), then shared by two threads with batches
     of their own, each batch with a corrupted and a short row, every
     call equal to `oracle.verify`; each service again from an .npz
     cache it wrote; then the CLI (`python -m dilithium_tpu_torch --level
     3`) in subprocesses on the card, exit codes 0, 0, 0 and 1 after a
     flipped byte. 8b, full width at Dilithium-3, the JAX package's bench
     operating points: `keys` (a `MultiSigner` of 256 keys, 16384
     messages of 200 bytes with a random key each, W = 768, from bytes),
     `stream` (`scheme.sign_stream`, one key, Q = 16384, W = 768) and
     `lockstep` (`scheme.sign`, 16384 keys, 4 attempts a round, at most
     96 rounds; all 16384 keys equal `oracle.keygen`); each run counted
     (K1, K3 and K4 must launch), every signature ok and accepted by
     `oracle.verify`, 512 equal to `oracle.sign` in bytes and attempts;
     signs/s (median of 3 timed
     runs after the checked run), rounds and peak memory; then one
     profiled stream queue (device time per round by kernel group, busy
     share, the rest's largest kernels). 8a ends with the KAT replay
     (`tools/kat_replay.replay`, levels 2, 3 and 5) when
     DILITHIUM_KAT_DIR names a directory, and otherwise says it did not
     run;
  9. the data-parallel services and the launcher. 9a, a world of one
     rank (NCCL on the card, a FileStore in a temporary directory): every
     service of `dilithium_tpu_torch.parallel` on the inputs of phases 5,
     7 and 8b, equal to their results (sig, attempts and ok, or
     accept/reject) with counters equal to the local sums, counted (K1-K4
     must launch), then timed in turns with the single-card call beneath
     it. 9b, `python -m dilithium_tpu_torch.tools.run_multihost` in one
     process per visible card over NCCL: `--signer mxu --verify` at
     16384 messages a card and `--signer keys --nkeys 1 --verify` at 2048
     a card, every process with the global counters, the shards accepted
     by oracle.verify and 512 equal to oracle.sign; then phase 9's
     seconds.
 10. the port's measurement entry points at full width, each in its own
     process: `python -m dilithium_tpu_torch.bench` in its six modes at
     level 3 and in `mxu` and `verify` at levels 2 and 5
     (DILITHIUM_BENCH_ITERS=3: three timed blocks of one call, the 15%
     guard, the gate on), each mode's value, blocks and spread;
     `tools/sweep_window.py` at level 3 over W = 512, 768, 1024 and 1536;
     `bench_round` at W = 768; `bench_components` at B = 1024 with its
     latencies at B = 1 and 64; `tools/profile_sign` (W = 768) and
     `tools/profile_verify` (B = 16384); `bench_scaling` in one process a
     visible card. A failure in any exits non-zero; K1-K5 must show
     launches in the `launches` lines the entry points print;
     10b. every shape the entry points launched (their `shapes` lines:
     a kernel and the scalar arguments of its launch) that no row of
     phases 3 and 6 ran, against its plain version, bit-equal, on
     inputs of its own generator (K1 at levels 2 and 5 and at
     bench_components' sizes, K2 at levels 2 and 5 and the sweep's
     windows, K3 at every tau, K4 at bench_components' batches, K5 on
     [30720, 25], ...), each row with its time and bound.
Then one JSON line with every kernel's launches (phase 5 for K1-K4,
phase 6 for K5-K7; `verify_launches` from phase 7, `api_launches` from
phase 8's counted runs, `parallel_launches` from phase 9a's,
`entry_launches` from phase 10's entry points), error, time,
device-only time, plain time, bound and share (bound / device-only time),
the card line again, and last
{"ok": true, "device": {...}}.

A kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its 32-bit integer instructions
over 64 a clock on each SM at the card's maximum SM clock (nvidia-smi
clocks.max.sm); a Keccak-f[1600] counts PERM_OPS instructions.

Needs no network and imports nothing of JAX; the C++ oracle (cpp/) is
built with make on first use.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch

SEED = 2026
Q_MAIN, W_MAIN = 16384, 768
LOCKSTEP_Q, ATTEMPTS, LOCKSTEP_ROUNDS = 16384, 4, 96  # the lockstep signer's operating point
N_KEYS = 256  # the MultiSigner run's keys
MSG_LEN = 200  # its messages' length in bytes
N_GATE, N_GATE_KEYS = 64, 8  # phase 8a: messages and keys a level
N_ORACLE_SIGN = 512
TOP_REST = 8  # kernels of the verify profile's "rest" printed by name
N_STATES, N_POLYS = 131072, 65536  # the kernel bench's full width

KERNELS = {
    "sponge": ("dilithium_tpu_torch/csrc/sponge.cu", "dilithium_tpu/ops/keccak_pallas.py:217"),
    "mask_limbs": ("dilithium_tpu_torch/csrc/mask_limbs.cu", "dilithium_tpu/ops/keccak_pallas.py:172"),
    "ball": ("dilithium_tpu_torch/csrc/ball.cu", "dilithium_tpu/ops/ball_pallas.py:80"),
    "ntt": ("dilithium_tpu_torch/csrc/ntt.cu", "dilithium_tpu/ops/ntt_pallas.py:177"),
    "permute": ("dilithium_tpu_torch/csrc/permute.cu", "dilithium_tpu/ops/keccak_pallas.py:43"),
    "sponge_planes": ("dilithium_tpu_torch/csrc/sponge_planes.cu", "tools/xof_exp.py:68"),
    "ball_bitplane": ("dilithium_tpu_torch/csrc/ball_bitplane.cu", "tools/ball_exp.py:102"),
}
MAIN_KERNELS = ("sponge", "mask_limbs", "ball", "ntt")
BENCH_KERNELS = ("permute", "sponge_planes", "ball_bitplane")

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_PER_SM_CLOCK = 64  # 32-bit integer lanes per SM (Hopper)
# 32-bit instructions of one Keccak-f[1600] with 3-input logic (LOP3) and
# 64-bit rotates as two funnel shifts, per round: theta's column parities
# 20, its five rotates 10, its 25 lane updates 50, rho 48, chi 50, iota 2
PERM_OPS = 24 * 180
# a Shoup butterfly: 3 multiplies and 6 adds, subtracts and selects
BUTTERFLY_OPS = 9


def sponge_work(batch: int, msg_len: int, out_bytes: int, rate: int):
    """(bytes, ops) of a sponge over [batch, msg_len] -> out_bytes."""
    perms = msg_len // rate + 1 + -(-out_bytes // rate) - 1
    return batch * (msg_len + out_bytes), batch * perms * PERM_OPS


def ntt_work(batch: int, inverse: bool):
    """(bytes, ops) of batch NTTs: 8 x 128 butterflies, and the inverse's
    256 scaling products (4 ops each)."""
    return batch * 2 * 256 * 4, batch * (8 * 128 * BUTTERFLY_OPS + (256 * 4 if inverse else 0))


def ball_consumed(stream: torch.Tensor, tau: int) -> torch.Tensor:
    """Bytes of each stream row that SampleInBall reads (int64 [B]): the 8
    sign bytes and the rest up to the tau-th take, or the whole row where
    the walk runs out."""
    s = stream.to(torch.int32)
    b, nbytes = s.shape
    i = torch.full((b,), 256 - tau, dtype=torch.int32, device=s.device)
    end = torch.full((b,), nbytes, dtype=torch.int64, device=s.device)
    for pos in range(8, nbytes):
        take = (s[:, pos] <= i) & (i < 256)
        i += take.to(torch.int32)
        end = torch.where(take & (i == 256), pos + 1, end)
    return end


def ball_work(stream: torch.Tensor, tau: int):
    """(bytes, ops) of SampleInBall on this run's streams: of each row the
    32-byte sectors that hold the bytes its walk reads (`ball_consumed`,
    where the row lies in memory), c (int32) and ok written; ops count
    one per output coefficient only (a lower bound)."""
    b = stream.shape[0]
    start = stream.data_ptr() % 32 + torch.arange(b, dtype=torch.int64, device=stream.device) * stream.stride(0)
    sectors = (start + ball_consumed(stream, tau) - 1) // 32 - start // 32 + 1
    return int(sectors.sum()) * 32 + b * (256 * 4 + 1), b * 256


def ball_stream_work(batch: int, nbytes: int):
    """(bytes, ops) of SampleInBall as earlier runs bounded it: the whole
    stream read, whatever the walks need of it."""
    return batch * (nbytes + 256 * 4 + 1), batch * 256


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()
    return float(out[0]) * 1e6


def bound(work, int_ops_per_s: float):
    """(bound_ms, bound_by) of (bytes, ops)."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / int_ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of fn, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().cpu())


def comparer(phase: str, rows: list, int_ops: float):
    """compare(kernel, label, fn, plain_fn, work, primary): check fn
    against plain_fn bit for bit, time both, and append a row, with the
    shapes (`_kernels.SHAPES` keys) fn's first call launched. A second
    bound, `stream_work` (SampleInBall's whole stream, as earlier runs
    counted it), is printed and kept beside the first."""
    from dilithium_tpu_torch import _kernels
    from dilithium_tpu_torch.bench_kernels import device_ms

    def compare(kernel, label, fn, plain_fn, work, primary=False, time_plain=True, stream_work=None):
        before = Counter(_kernels.SHAPES)
        got = fn()
        shapes = set(_kernels.SHAPES - before)
        ref = plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0.0:
            raise AssertionError(f"{kernel} {label} differs from its plain version")
        ms, dev_ms = time_ms(fn), device_ms(fn)
        plain_ms = time_ms(plain_fn) if time_plain else None
        bound_ms, bound_by = bound(work, int_ops)
        plain = f"{plain_ms:.4f} ms" if time_plain else "not timed"
        second = ""
        if stream_work is not None:
            stream_ms = bound(stream_work, int_ops)[0]
            second = f"; whole-stream bound {stream_ms:.6f} ms ({stream_ms / dev_ms:.2%})"
        print(f"{phase}: {kernel} {label}: max_abs_err {err} kernel {ms:.4f} ms device {dev_ms:.4f} ms "
              f"plain {plain} bound {bound_ms:.6f} ms ({bound_by}, {bound_ms / dev_ms:.2%} of device){second}")
        rows.append({"kernel": kernel, "shape": label, "err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "work": work, "stream_work": stream_work, "primary": primary,
                     "shapes": shapes})
    return compare


def check_kernels(rng, dev, int_ops):
    """Phase 3: kernel vs plain version at the main path's shapes and at
    edge shapes."""
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.ops import keccak, ntt, sampling
    from dilithium_tpu_torch.tools import ball_edges

    p = get_params(3)
    rows = []
    compare = comparer("phase 3", rows, int_ops)

    # the edge rows draw from their own generator, so the main path's
    # inputs in later phases stay those of earlier runs
    edge_rng = np.random.default_rng(SEED + 1)

    def u8(*shape, g=rng):
        return torch.from_numpy(g.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    sponge_shapes = [  # label, batch, msg_len, out_bytes, rate, domain, byte offset of the rows
        ("seedbuf", 1, 32, 128, 136, 0x1F, 0),
        ("expand_a", p.K * p.L, 34, 840, 168, 0x1F, 0),
        ("expand_s", p.K + p.L, 66, p.eta_blocks * 136, 136, 0x1F, 0),
        ("tr", 1, p.pk_bytes, 32, 136, 0x1F, 0),
        ("rhoprime", Q_MAIN, 96, 64, 136, 0x1F, 0),
        ("c_tilde", W_MAIN, 64 + p.K * p.polyw1_packedbytes, 32, 136, 0x1F, 0),
        ("ball_stream", W_MAIN, 32, 272, 136, 0x1F, 0),
        # edges of the staged I/O: ragged batches, lengths off the 8- and
        # 16-byte grain and at multiples of the rate, outputs off 8 bytes,
        # the three rates, rows that start off a 16-byte boundary
        ("edge", 769, 33, 33, 136, 0x1F, 0),
        ("edge", 33, 66, 150, 168, 0x1F, 0),
        ("edge sha3-512", 33, 97, 64, 72, 0x06, 0),
        ("edge sha3-512", 769, 72, 64, 72, 0x06, 0),
        ("edge", 33, 1952, 150, 136, 0x1F, 0),
        ("edge", 769, 136, 33, 136, 0x1F, 0),
        ("edge", 33, 168, 150, 168, 0x1F, 0),
        ("edge", 33, 272, 408, 136, 0x1F, 0),
        ("edge offset 3", 33, 97, 150, 136, 0x1F, 3),
    ]
    for label, b, n, out, rate, domain, offset in sponge_shapes:
        if label.startswith("edge"):  # contiguous rows, offset bytes past their allocation's start
            msg = u8(b * n + offset, g=edge_rng)[offset:].view(b, n)
        else:
            msg = u8(b, n)
        compare("sponge", f"{label} [{b}, {n}] -> {out} rate {rate}",
                lambda: keccak.sponge(msg, out, rate, domain),
                lambda: keccak.sponge_plain(msg, out, rate, domain),
                sponge_work(b, n, out, rate), primary=label == "c_tilde")

    # the verify path's sponges at phase 7's batch: the ball stream and
    # c_tilde' = SHAKE256(mu || w1') of Q_MAIN signatures (a generator of
    # their own, so the rows above and below keep their inputs)
    verify_rng = np.random.default_rng(SEED + 2)
    for label, n, out in (("verify ball_stream", 32, 272),
                          ("verify c_tilde", 64 + p.K * p.polyw1_packedbytes, 32)):
        msg = u8(Q_MAIN, n, g=verify_rng)
        compare("sponge", f"{label} [{Q_MAIN}, {n}] -> {out} rate 136",
                lambda: keccak.sponge(msg, out, 136, 0x1F),
                lambda: keccak.sponge_plain(msg, out, 136, 0x1F), sponge_work(Q_MAIN, n, out, 136))

    # the generic signers' ExpandMask: a stream round's W x L messages and a
    # lockstep round's B x A x L (a generator of their own, as above)
    generic_rng = np.random.default_rng(SEED + 5)
    for label, b in (("stream expand_mask", W_MAIN * p.L), ("lockstep expand_mask", LOCKSTEP_Q * ATTEMPTS * p.L)):
        msg = u8(b, 66, g=generic_rng)
        compare("sponge", f"{label} [{b}, 66] -> {p.polyz_packedbytes} rate 136",
                lambda: keccak.sponge(msg, p.polyz_packedbytes, 136, 0x1F),
                lambda: keccak.sponge_plain(msg, p.polyz_packedbytes, 136, 0x1F),
                sponge_work(b, 66, p.polyz_packedbytes, 136))

    # phase 8b's other sponges: the key set-up of keygen and expand_sk at
    # the `keys` run's N_KEYS keys and the `lockstep` run's LOCKSTEP_Q, and
    # a lockstep round's B x A c_tilde and ball stream (a generator of
    # their own, as above)
    setup_rng = np.random.default_rng(SEED + 6)
    setup_shapes = [(f"{run} {label}", b, n, out, rate) for run, keys in (("keys", N_KEYS), ("lockstep", LOCKSTEP_Q))
                    for label, b, n, out, rate in (
                        ("seedbuf", keys, 32, 128, 136),
                        ("expand_a", keys * p.K * p.L, 34, p.uniform_blocks * 168, 168),
                        ("expand_s", keys * (p.K + p.L), 66, p.eta_blocks * 136, 136),
                        ("tr", keys, p.pk_bytes, 32, 136))]
    setup_shapes += [("lockstep c_tilde", LOCKSTEP_Q * ATTEMPTS, 64 + p.K * p.polyw1_packedbytes, 32, 136),
                     ("lockstep ball_stream", LOCKSTEP_Q * ATTEMPTS, 32, p.ball_blocks * 136, 136)]
    for label, b, n, out, rate in setup_shapes:
        msg = u8(b, n, g=setup_rng)
        compare("sponge", f"{label} [{b}, {n}] -> {out} rate {rate}",
                lambda: keccak.sponge(msg, out, rate, 0x1F),
                lambda: keccak.sponge_plain(msg, out, rate, 0x1F), sponge_work(b, n, out, rate))

    for level, W, kappa_at in ((3, W_MAIN, None), (3, 769, None), (2, W_MAIN, None),
                               (5, W_MAIN, None), (3, 64, 65534)):
        lp = get_params(level)
        g = rng if (level, W, kappa_at) == (3, W_MAIN, None) else edge_rng
        rp = u8(W, 64, g=g)
        if kappa_at is None:
            kappa = torch.from_numpy(g.integers(0, 400, W).astype(np.int32) * lp.L).to(dev)
        else:  # kappa + l wraps past 2^16 inside the row
            kappa = torch.full((W,), kappa_at, dtype=torch.int32, device=dev)
        compare("mask_limbs", f"level {level} W={W} L={lp.L}" + (f" kappa={kappa_at}" if kappa_at else ""),
                lambda: sampling.expand_mask_limbs(rp, kappa, lp),
                lambda: sampling.mask_limbs_plain(rp, kappa, lp),
                (W * (64 + 4 + 3 * lp.L * 256),
                 W * lp.L * sponge_work(1, 66, lp.polyz_packedbytes, 136)[1]),
                primary=(level, W, kappa_at) == (3, W_MAIN, None))

    stream = keccak.sponge_plain(u8(W_MAIN, 32), 272, 136, 0x1F)
    stream[:4, 8:] = 255  # no candidate taken: ok = 0, the j = 0 fill path

    compare("ball", f"level 3 B={W_MAIN}", lambda: sampling.sample_in_ball_stream(stream, p.tau),
            lambda: sampling.sample_in_ball_plain(stream, p.tau), ball_work(stream, p.tau), primary=True,
            stream_work=ball_stream_work(W_MAIN, 272))
    # K3's edges at every level: ragged batches around its 4 warps a block;
    # the band-heavy, exact-limit, all-take, no-take and last-byte rows of
    # `ball_edges` at the top of each batch (four no-take rows after them);
    # a 136-byte stream; rows off the 4-byte alignment (a 272-byte row
    # 3 bytes into its allocation, 270-byte rows at alternate alignments)
    for level in (2, 3, 5):
        tau = get_params(level).tau
        for b, nbytes, offset in ((1, 272, 0), (33, 272, 0), (W_MAIN, 272, 0), (769, 272, 0),
                                  (16384, 272, 0), (769, 136, 0), (769, 272, 3), (769, 270, 0)):
            rows_np = edge_rng.integers(0, 256, (b, nbytes), dtype=np.uint8)
            edges = ball_edges.edge_streams(tau, nbytes, seed=level)
            if b > 1:
                rows_np[:len(edges)] = edges[:b]
                rows_np[len(edges):len(edges) + 4, 8:] = 255
            flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8), rows_np.reshape(-1)])).to(dev)
            st = flat[offset:].view(b, nbytes)
            compare("ball", f"edge level {level} B={b} {nbytes} B" + (f" offset {offset}" if offset else ""),
                    lambda: sampling.sample_in_ball_stream(st, tau),
                    lambda: sampling.sample_in_ball_plain(st, tau), ball_work(st, tau),
                    stream_work=ball_stream_work(b, nbytes))

    # a lockstep round's challenges: B x A streams
    st = keccak.sponge_plain(u8(LOCKSTEP_Q * ATTEMPTS, 32, g=generic_rng), 272, 136, 0x1F)
    compare("ball", f"lockstep level 3 B={st.shape[0]}", lambda: sampling.sample_in_ball_stream(st, p.tau),
            lambda: sampling.sample_in_ball_plain(st, p.tau), ball_work(st, p.tau),
            stream_work=ball_stream_work(st.shape[0], 272))

    def coeffs(b, g=rng):
        return torch.from_numpy(g.integers(0, 8380417, (b, 256)).astype(np.int32)).to(dev)

    def fill(b, v):
        return torch.full((b, 256), v, dtype=torch.int32, device=dev)

    inv_plain = (lambda v: ntt.invntt(v, False), lambda v: ntt.invntt_plain(v, False))
    inv_product = (ntt.invntt, ntt.invntt_plain)
    forward = (ntt.ntt, ntt.ntt_plain)
    for label, x, (fn, plain_fn), primary in [
        ("forward [5, 256]", coeffs(5), forward, False),
        ("inverse plain [30, 256]", coeffs(30), inv_plain, True),
        ("inverse product [6, 256]", coeffs(6), inv_product, False),
        ("forward [4096, 256]", coeffs(4096), forward, False),
        ("inverse product [4096, 256]", coeffs(4096), inv_product, False),
        # K4's edges: one polynomial; batches just past the block kernel's
        # limit and off the warp kernel's 8 warps a block (513), over what
        # the card holds resident (65536: the grid walks the batch); the
        # extreme inputs and both inverse scales through both kernels
        ("edge forward [1, 256]", coeffs(1, edge_rng), forward, False),
        ("edge inverse plain [1, 256]", coeffs(1, edge_rng), inv_plain, False),
        ("edge forward [129, 256]", coeffs(129, edge_rng), forward, False),
        ("edge inverse product [129, 256]", coeffs(129, edge_rng), inv_product, False),
        ("edge forward [513, 256]", coeffs(513, edge_rng), forward, False),
        ("edge inverse plain [513, 256]", coeffs(513, edge_rng), inv_plain, False),
        ("edge forward [65536, 256]", coeffs(65536, edge_rng), forward, False),
        ("edge inverse product [65536, 256]", coeffs(65536, edge_rng), inv_product, False),
        ("edge inverse plain [65536, 256]", coeffs(65536, edge_rng), inv_plain, False),
        # verify_expanded at Q_MAIN signatures, level 3: z forward (Q_MAIN x L
        # polynomials), w' inverse (Q_MAIN x K)
        (f"verify forward [{Q_MAIN * p.L}, 256]", coeffs(Q_MAIN * p.L, verify_rng), forward, False),
        (f"verify inverse product [{Q_MAIN * p.K}, 256]", coeffs(Q_MAIN * p.K, verify_rng), inv_product, False),
        # a lockstep round at B = LOCKSTEP_Q, A = ATTEMPTS: y forward (B x A x
        # L polynomials), w, c s2 and c t0 inverse (B x A x K)
        (f"lockstep forward [{LOCKSTEP_Q * ATTEMPTS * p.L}, 256]", coeffs(LOCKSTEP_Q * ATTEMPTS * p.L, generic_rng),
         forward, False),
        (f"lockstep inverse product [{LOCKSTEP_Q * ATTEMPTS * p.K}, 256]",
         coeffs(LOCKSTEP_Q * ATTEMPTS * p.K, generic_rng), inv_product, False),
        # phase 8b's key set-up: keygen's NTT(s1) and A s1 inverse, and
        # expand_sk's s1, s2 and t0 forward, at N_KEYS and LOCKSTEP_Q keys
        # (LOCKSTEP_Q x L forward and x K inverse are the verify rows' shapes)
        (f"keys forward [{N_KEYS * p.L}, 256]", coeffs(N_KEYS * p.L, setup_rng), forward, False),
        (f"keys forward [{N_KEYS * p.K}, 256]", coeffs(N_KEYS * p.K, setup_rng), forward, False),
        (f"keys inverse product [{N_KEYS * p.K}, 256]", coeffs(N_KEYS * p.K, setup_rng), inv_product, False),
        (f"lockstep forward [{LOCKSTEP_Q * p.K}, 256]", coeffs(LOCKSTEP_Q * p.K, setup_rng), forward, False),
    ] + [
        (f"edge {name} {label} [{b}, 256]", fill(b, v), fns, False)
        for b in (129, 513) for label, v in (("zeros", 0), ("q-1", 8380416))
        for name, fns in (("forward", forward), ("inverse product", inv_product), ("inverse plain", inv_plain))
    ]:
        compare("ntt", label, lambda: fn(x), lambda: plain_fn(x),
                ntt_work(x.shape[0], "inverse" in label), primary)
    return rows


def check_small_slice(rng, dev):
    """Phase 4: Dilithium-2, Q = 64, W = 32, card vs the plain CPU path."""
    from dilithium_tpu_torch import mxu, scheme
    from dilithium_tpu_torch.params import get_params

    p = get_params(2)
    seed = torch.from_numpy(rng.integers(0, 256, 32, dtype=np.uint8))
    mus = torch.from_numpy(rng.integers(0, 256, (64, 64), dtype=np.uint8))
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        kp = scheme.keygen(seed.to(d), p)
        ops = mxu.build_operators(kp.sk, p)
        res = mxu.sign_stream_mxu(ops, mus.to(d), p, window=32)
        out[name] = [t.cpu() for t in (kp.pk, kp.sk, ops.wy_cat, ops.c_cat, res.sig, res.attempts, res.ok)]
    for field, a, b in zip(("pk", "sk", "wy_cat", "c_cat", "sig", "attempts", "ok"), out["cuda"], out["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"small slice: {field} differs between the card and the CPU")
    if not bool(out["cuda"][6].all()):
        raise AssertionError("small slice: a signature is not ok")
    print(f"phase 4: Dilithium-2 Q=64 W=32 card == CPU plain path "
          f"(pk, sk, operators, sig, attempts, ok); mean attempts {out['cuda'][5].float().mean().item():.3f}")


def verify_all(pk, sig, mu, p):
    """The port's three verifiers on sig uint8 [R, sig_bytes], mu uint8
    [R, 64] under one pk uint8 [pk_bytes], all on one device -> {name: bool
    numpy [R]}: `verify_mxu` (through `MxuVerifier`), `verify_expanded` and
    `verify` (A expanded per lane)."""
    from dilithium_tpu_torch import mxu, scheme

    verifier = mxu.MxuVerifier(mxu.build_verify_operators(pk, p), p)
    return {
        "verify_mxu": verifier(sig, mu).cpu().numpy(),
        "verify_expanded": scheme.verify_expanded(scheme.expand_pk(pk, p), sig, mu, p).cpu().numpy(),
        "verify": scheme.verify(pk.expand(sig.shape[0], -1), sig, mu, p).cpu().numpy(),
    }


def negative_rows(level, sig, mus, seed):
    """Corrupted rows of every class of `tools/verify_cases.py` from valid
    (sig, mu) rows under one key, with a signature under another oracle
    key."""
    from dilithium_tpu_torch import oracle
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import verify_cases

    g = np.random.default_rng(seed)
    _, sk_f = oracle.keygen(level, g.integers(0, 256, (1, 32), dtype=np.uint8))
    mu_f = g.integers(0, 256, (1, 64), dtype=np.uint8)
    sig_f, _ = oracle.sign(level, sk_f, mu_f)
    return verify_cases.negative_cases(sig, mus, sig_f[0], mu_f[0], get_params(level), seed=seed)


def check_small_verify(dev):
    """Phase 4, verify: levels 2 and 5, an oracle key, 64 signatures and
    the corrupted rows; the three verifiers on the card and on the CPU
    plain path, equal to each other and to oracle.verify."""
    from dilithium_tpu_torch import oracle
    from dilithium_tpu_torch.params import get_params

    for level in (2, 5):
        p = get_params(level)
        g = np.random.default_rng(SEED + 3 + level)
        pk_o, sk_o = oracle.keygen(level, g.integers(0, 256, (1, 32), dtype=np.uint8))
        mus = g.integers(0, 256, (64, 64), dtype=np.uint8)
        sig, _ = oracle.sign(level, np.repeat(sk_o, 64, axis=0), mus)
        bad_sig, bad_mu, names = negative_rows(level, sig, mus, SEED + level)
        sig_all, mu_all = np.concatenate([sig, bad_sig]), np.concatenate([mus, bad_mu])
        expect = oracle.verify(level, np.repeat(pk_o, len(mu_all), axis=0), mu_all, sig_all)
        if not (expect[:64].all() and not expect[64:].any()):
            raise AssertionError(f"phase 4 verify level {level}: the oracle's answers are not as built")
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            got = verify_all(*(torch.from_numpy(x).to(d) for x in (pk_o[0], sig_all, mu_all)), p)
            for verifier, ok in got.items():
                if not np.array_equal(ok, expect):
                    raise AssertionError(f"phase 4 verify level {level}: {verifier} on the {name} "
                                         f"differs from oracle.verify at rows {np.nonzero(ok != expect)[0]}")
        print(f"phase 4: verify level {level}: verify_mxu, verify_expanded and verify on the card and on "
              f"the CPU == oracle.verify on 64 valid and {len(names)} corrupted rows "
              f"({', '.join(sorted(set(names)))})")


def check_other_device(rng_seed: int = SEED + 4):
    """The device guard: K1, K2, K3 and K4 (both of its kernels) and a small
    MxuVerifier run on cuda:1 while cuda:0 is current, bit-equal to their
    plain versions. Needs two devices; prints that it did not run
    otherwise."""
    from dilithium_tpu_torch import mxu, oracle
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.ops import keccak, ntt, sampling

    n = torch.cuda.device_count()
    if n < 2:
        print(f"device guard: the check runs kernels on cuda:1 while cuda:0 is current and needs two "
              f"devices; this machine has {n}: not run")
        return
    g = np.random.default_rng(rng_seed)
    p = get_params(3)
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    msg = torch.from_numpy(g.integers(0, 256, (769, 832), dtype=np.uint8)).to(other)
    rp = torch.from_numpy(g.integers(0, 256, (769, 64), dtype=np.uint8)).to(other)
    kappa = torch.from_numpy(g.integers(0, 400, 769).astype(np.int32) * p.L).to(other)
    stream = keccak.sponge_plain(msg[:, :32], 272, 136, 0x1F)
    checks = [
        ("K1", lambda: keccak.sponge(msg, 32, 136, 0x1F), lambda: keccak.sponge_plain(msg, 32, 136, 0x1F)),
        ("K2", lambda: sampling.expand_mask_limbs(rp, kappa, p), lambda: sampling.mask_limbs_plain(rp, kappa, p)),
        ("K3", lambda: sampling.sample_in_ball_stream(stream, p.tau),
         lambda: sampling.sample_in_ball_plain(stream, p.tau)),
    ]
    for b in (30, 4096):
        x = torch.from_numpy(g.integers(0, 8380417, (b, 256)).astype(np.int32)).to(other)
        checks += [(f"K4 forward [{b}, 256]", lambda x=x: ntt.ntt(x), lambda x=x: ntt.ntt_plain(x)),
                   (f"K4 inverse [{b}, 256]", lambda x=x: ntt.invntt(x), lambda x=x: ntt.invntt_plain(x))]
    for name, fn, plain_fn in checks:
        got, ref = fn(), plain_fn()
        torch.cuda.synchronize(other)
        if torch.cuda.current_device() != 0 or max_abs_err(got, ref) != 0.0:
            raise AssertionError(f"device guard: {name} on cuda:1 differs from its plain version")
    pk_o, sk_o = oracle.keygen(3, g.integers(0, 256, (1, 32), dtype=np.uint8))
    mus = g.integers(0, 256, (20, 64), dtype=np.uint8)
    sig, _ = oracle.sign(3, np.repeat(sk_o, 20, axis=0), mus)
    sig[3, 100] ^= 1
    verifier = mxu.MxuVerifier(mxu.build_verify_operators(torch.from_numpy(pk_o[0]), p), p).to(other)
    ok = verifier(torch.from_numpy(sig).to(other), torch.from_numpy(mus).to(other)).cpu().numpy()
    if not np.array_equal(ok, oracle.verify(3, np.repeat(pk_o, 20, axis=0), mus, sig)):
        raise AssertionError("device guard: MxuVerifier on cuda:1 differs from oracle.verify")
    print(f"device guard: {', '.join(c[0] for c in checks)} and MxuVerifier on cuda:1 with cuda:0 current "
          f"({n} devices): bit-equal to their plain versions, verify == oracle.verify")


def main_path(rng, dev):
    """Phase 5: the main path at full size, counted, checked and timed.
    -> (launches, the key, its operators, the queue and its result, for
    phases 7 and 9)."""
    from dilithium_tpu_torch import _kernels, mxu, oracle, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import round_profile

    p = get_params(3)
    seed_np = rng.integers(0, 256, 32, dtype=np.uint8)
    mus_np = rng.integers(0, 256, (Q_MAIN, 64), dtype=np.uint8)
    seed = torch.from_numpy(seed_np).to(dev)
    mus = torch.from_numpy(mus_np).to(dev)

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    kp = scheme.keygen(seed, p)
    signer = mxu.MxuSigner(mxu.build_operators(kp.sk, p), p, window=W_MAIN)
    torch.cuda.synchronize()
    t_key = time.perf_counter() - t0
    res = signer(mus)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0 - t_key
    launches = _kernels.launches()
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")

    sig, att, ok = res.sig.cpu().numpy(), res.attempts.cpu().numpy(), res.ok.cpu().numpy()
    if not (ok.all() and bool(kp.ok)):
        raise AssertionError(f"main path: {int((~ok).sum())} signatures not ok")
    pk_o, sk_o = oracle.keygen(3, seed_np[None])
    if not (np.array_equal(kp.pk.cpu().numpy(), pk_o[0]) and np.array_equal(kp.sk.cpu().numpy(), sk_o[0])):
        raise AssertionError("main path: keygen differs from the oracle")
    pk_b = np.repeat(pk_o, Q_MAIN, axis=0)
    if not oracle.verify(3, pk_b, mus_np, sig).all():
        raise AssertionError("main path: the oracle rejects a signature")
    sig_o, att_o = oracle.sign(3, np.repeat(sk_o, N_ORACLE_SIGN, axis=0), mus_np[:N_ORACLE_SIGN])
    if not (np.array_equal(sig[:N_ORACLE_SIGN], sig_o) and np.array_equal(att[:N_ORACLE_SIGN], att_o)):
        raise AssertionError("main path: signatures differ from the oracle's")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = signer(mus)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if not torch.equal(again.sig, res.sig):
        raise AssertionError("main path: a repeated run gave other signatures")
    rate = Q_MAIN / statistics.median(times)
    print(f"phase 5: Dilithium-3 Q={Q_MAIN} W={W_MAIN}: {rate:.1f} signs/s "
          f"(median of {len(times)} runs {[round(x, 4) for x in times]} s; first run {t_first:.3f} s, "
          f"keygen+operators {t_key:.3f} s), rounds {res.rounds}, mean attempts {att.mean():.4f}; "
          f"all ok, oracle verifies {Q_MAIN}, {N_ORACLE_SIGN} equal oracle.sign; launches {launches}")
    prof = round_profile.profile_rounds(signer, mus, res.sig)
    if prof is None:
        print("phase 5: profile: the profiler recorded no device events; device breakdown not measured")
    else:
        print(f"phase 5: profile of one more run (torch.profiler, CUDA activity): {round_profile.describe(*prof)}")
    return launches, {"pk": kp.pk, "sk": kp.sk, "ops": signer.operators, "mus": mus, "mus_np": mus_np,
                      "sig": sig, "res": res}


def verify_path(main, dev):
    """Phase 7: one-key verify at full width, Dilithium-3, phase 5's key
    and its Q_MAIN signatures plus a block of corrupted rows: the three
    verifiers against the oracle, counted; verifies/s of `verify_mxu` and
    `verify_expanded`; one profiled `verify_mxu` call. -> (launches, the
    rows, their oracle answers and the key material, for phase 9)."""
    from dilithium_tpu_torch import _kernels, mxu, oracle, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import round_profile

    p = get_params(3)
    pk, mus_np, sig_np = main["pk"], main["mus_np"], main["sig"]
    bad_sig, bad_mu, names = negative_rows(3, sig_np[:5], mus_np[:5], SEED + 7)
    sig_all = torch.from_numpy(np.concatenate([sig_np, bad_sig])).to(dev)
    mu_all = torch.from_numpy(np.concatenate([mus_np, bad_mu])).to(dev)
    n_bad = len(names)
    # `verify` expands A per lane: the first N_ORACLE_SIGN rows and the corrupted ones
    lane_rows = tuple(torch.cat([x[:N_ORACLE_SIGN], x[Q_MAIN:]]) for x in (sig_all, mu_all))
    expect = oracle.verify(3, np.repeat(pk.cpu().numpy()[None], Q_MAIN + n_bad, axis=0),
                           mu_all.cpu().numpy(), sig_all.cpu().numpy())
    if not (expect[:Q_MAIN].all() and not expect[Q_MAIN:].any()):
        raise AssertionError("verify path: the oracle's answers are not as built")

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    verifier = mxu.MxuVerifier(mxu.build_verify_operators(pk, p), p)
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t
    t = time.perf_counter()
    epk = scheme.expand_pk(pk, p)
    torch.cuda.synchronize()
    t_epk = time.perf_counter() - t
    peak = {}
    got = {}
    for name, fn, rows in (
        ("verify_mxu", lambda: verifier(sig_all, mu_all), (sig_all, mu_all)),
        ("verify_expanded", lambda: scheme.verify_expanded(epk, sig_all, mu_all, p), (sig_all, mu_all)),
        ("verify", lambda: scheme.verify(pk.expand(lane_rows[0].shape[0], -1), *lane_rows, p), lane_rows),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got[name] = fn().cpu().numpy()
        top = torch.cuda.max_memory_allocated()
        peak[name] = (top / 2**20, (top - base) / 2**20)
    launches = _kernels.launches()
    missing = [k for k in ("sponge", "ball", "ntt") if launches[k] == 0]
    if missing:
        raise AssertionError(f"verify path launched no {missing} kernel")
    expect_lane = np.concatenate([expect[:N_ORACLE_SIGN], expect[Q_MAIN:]])
    for name, ok in got.items():
        want = expect_lane if name == "verify" else expect
        if not np.array_equal(ok, want):
            raise AssertionError(f"verify path: {name} differs from oracle.verify at rows "
                                 f"{np.nonzero(ok != want)[0]}")

    sig_q, mu_q = sig_all[:Q_MAIN], mu_all[:Q_MAIN]
    rates = {}
    for name, fn in (("verify_mxu", lambda: verifier(sig_q, mu_q)),
                     ("verify_expanded", lambda: scheme.verify_expanded(epk, sig_q, mu_q, p))):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if not bool(ok.all()):
            raise AssertionError(f"verify path: a timed {name} run rejected a signature")
        rates[name] = (Q_MAIN / statistics.median(times), times)
    print(f"phase 7: Dilithium-3 verify, phase 5's key: verify_mxu and verify_expanded accept all {Q_MAIN}, "
          f"verify (A per lane) the first {N_ORACLE_SIGN}; all three reject {n_bad} corrupted rows "
          f"({', '.join(sorted(set(names)))}); every row == oracle.verify; launches {launches}")
    print("phase 7: " + "; ".join(
        f"{name} {rate:.1f} verifies/s (median of 3 runs {[round(x, 5) for x in times]} s)"
        for name, (rate, times) in rates.items())
        + f"; build_verify_operators {t_ops:.4f} s, expand_pk {t_epk:.4f} s; max_memory_allocated "
          f"{', '.join(f'{k} {a:.1f} MiB ({b:.1f} above the resident)' for k, (a, b) in peak.items())} "
          f"(verify on {lane_rows[0].shape[0]} rows, the others on {Q_MAIN + n_bad}); card {card_line()}")
    ok, us, busy, rest = round_profile.profile_call(lambda: verifier(sig_q, mu_q))
    if not bool(ok.all()):
        raise AssertionError("verify path: the profiled verify_mxu run rejected a signature")
    if us is None:
        print("phase 7: profile: the profiler recorded no device events; device breakdown not measured")
    else:
        groups = ", ".join(f"{g} {v:.1f} us" for g, v in us.items() if not g.startswith("K2"))
        print(f"phase 7: profile of one verify_mxu call over {Q_MAIN} signatures (torch.profiler, CUDA "
              f"activity): device time {groups}; total {sum(us.values()):.1f} us; busy share {busy:.4f}")
        top = sorted(rest.items(), key=lambda kv: -kv[1])[:TOP_REST]
        print(f"phase 7: the rest's {TOP_REST} largest kernels of {len(rest)}: "
              + "; ".join(f"{us_:.1f} us {name[:90]}" for name, us_ in top))
    return launches, {"sig": sig_all, "mu": mu_all, "expect": expect, "lane_rows": lane_rows,
                      "expect_lane": expect_lane, "vops": verifier.operators, "epk": epk}


def ab_turns(sides: dict) -> dict:
    """Median device-only ms of one call of each side, taken in turns
    (`bench_kernels.device_ms_turns`)."""
    from dilithium_tpu_torch.bench_kernels import device_ms_turns

    return {side: statistics.median(ms) for side, ms in device_ms_turns(sides).items()}


def check_bench_path(rng, dev, int_ops):
    """Phase 6: K5-K7 against their plain versions at their primary and
    edge shapes, K6 against K1 and K7 against K3 at the port's own shapes
    (bit-equal, then timed in turns), then the kernel bench at full width,
    counted."""
    from dilithium_tpu_torch import _kernels, bench_kernels
    from dilithium_tpu_torch.ops import keccak, sampling
    from dilithium_tpu_torch.params import SHAKE128_RATE, SHAKE256_RATE, get_params
    from dilithium_tpu_torch.tools import ball_edges, ball_exp, round_profile, xof_exp

    rows = []
    compare = comparer("phase 6", rows, int_ops)

    def lanes(b):
        return torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, (b, 25), dtype=np.int64)).to(dev)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    planes = lanes(N_STATES).t().contiguous()
    compare("permute", f"planes [25, {N_STATES}]", lambda: keccak.keccak_f1600_planes(planes),
            lambda: keccak.keccak_f1600_plain(planes.t().contiguous()).t(),
            (N_STATES * 400, N_STATES * PERM_OPS), primary=True)
    st = lanes(16421)  # a batch that is not a multiple of the block
    compare("permute", "[16421, 25]", lambda: keccak.keccak_f1600(st),
            lambda: keccak.keccak_f1600_plain(st), (st.shape[0] * 400, st.shape[0] * PERM_OPS))

    def planes_case(b, msg_len, out_words, rate, primary=False, form=None):
        msgs = u8(b, msg_len)
        xp = xof_exp.planes_for(msgs, rate)
        rate_w = rate // 8
        launched = xof_exp.k6_form(b)
        if form is not None and launched != form:
            raise AssertionError(f"K6 launches its {launched} form at {b} messages; the row is for the {form} form")
        compare("sponge_planes", f"[{xp.shape[0]}, {b}] -> [{b}, {out_words}] rate {rate} ({launched} form)",
                lambda: xof_exp.shake_words_batchmajor(xp, out_words, rate_w),
                lambda: xof_exp.shake_words_batchmajor_plain(xp, out_words, rate_w),
                (b * (xp.shape[0] + out_words) * 4, sponge_work(b, msg_len, 4 * out_words, rate)[1]),
                primary=primary)
        return msgs

    xb = bench_kernels.XOF_BATCH
    msgs = planes_case(xb, 66, 160, SHAKE256_RATE, primary=True)
    k1_err = max_abs_err(xof_exp.xof_bm(msgs, 160, SHAKE256_RATE), keccak.shake_words(msgs, 160, SHAKE256_RATE))
    print(f"phase 6: sponge_planes (planes_for + K6) vs K1 shake_words [{xb}, 66] -> 160 words: max_abs_err {k1_err}")
    if k1_err != 0.0:
        raise AssertionError("K6 differs from K1")
    rows[-1]["err"] = max(rows[-1]["err"], k1_err)
    # edges: a batch that is not a multiple of the block, SHAKE128's 21
    # lanes (ExpandA's 840 bytes), a 7-block absorb (c_tilde's 832 bytes),
    # one output word and an odd count; these batches take the pair form
    for b, msg_len, out_words, rate in ((xb + 3, 66, 160, SHAKE256_RATE), (1000, 34, 210, SHAKE128_RATE),
                                        (1000, 832, 8, SHAKE256_RATE), (1000, 66, 1, SHAKE256_RATE),
                                        (1000, 66, 37, SHAKE256_RATE)):
        planes_case(b, msg_len, out_words, rate)
    # and the thread form's (the larger batches' form) at a batch that is
    # not a multiple of its warp: one output word, an odd count, SHAKE128
    for msg_len, out_words, rate in ((66, 1, SHAKE256_RATE), (66, 37, SHAKE256_RATE), (34, 210, SHAKE128_RATE)):
        planes_case(16421, msg_len, out_words, rate, form="thread")

    # K6 against K1 at the port's shapes: a stream round's ExpandMask,
    # verify's c_tilde', a lockstep round's ExpandMask, key set-up's ExpandA
    answers = []
    for b, msg_len, out_words, rate in ((3840, 66, 160, SHAKE256_RATE), (16384, 832, 8, SHAKE256_RATE),
                                        (327680, 66, 160, SHAKE256_RATE), (491520, 34, 210, SHAKE128_RATE)):
        msgs = u8(b, msg_len)
        xp = xof_exp.planes_for(msgs, rate)
        k1 = keccak.shake_words(msgs, out_words, rate)
        err = max(max_abs_err(xof_exp.xof_bm(msgs, out_words, rate), k1),
                  max_abs_err(xof_exp.shake_words_batchmajor(xp, out_words, rate // 8).to(torch.int64) & 0xFFFFFFFF,
                              k1))
        if err != 0.0:
            raise AssertionError(f"K6 differs from K1 at [{b}, {msg_len}] -> {out_words} words")
        rows.append({"kernel": "sponge_planes", "shape": f"vs K1 [{b}, {msg_len}]", "err": err, "primary": False})
        del k1
        med = ab_turns({
            "K1": lambda: keccak.shake_words(msgs, out_words, rate),
            "planes+K6": lambda: xof_exp.xof_bm(msgs, out_words, rate),
            "K6": lambda: xof_exp.shake_words_batchmajor(xp, out_words, rate // 8),
        })
        answers.append((f"sponge [{b}, {msg_len}] -> {out_words}w", med))
        print(f"phase 6: sponge [{b}, {msg_len}] -> {out_words} words, K1 == planes+K6 == K6, device ms "
              f"(median of 3 in turns): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))

    # K7's primary row as in earlier runs: level 3, random streams with 4
    # no-take rows (ok = 0, the j = 0 fill)
    p = get_params(3)
    b = bench_kernels.BALL_BATCH
    stream = keccak.shake256(u8(b, 32), p.ball_blocks * SHAKE256_RATE)
    stream[:4, 8:] = 255
    compare("ball_bitplane", f"B={b}", lambda: ball_exp.sample_in_ball_v1(stream, p.tau),
            lambda: ball_exp.sample_in_ball_v1_plain(stream, p.tau), ball_work(stream, p.tau), primary=True,
            stream_work=ball_stream_work(b, stream.shape[1]))
    v1 = ball_exp.sample_in_ball_v1(stream, p.tau)
    if max_abs_err(v1, sampling.sample_in_ball_stream(stream, p.tau)) != 0.0 or bool(v1[1][:4].any()):
        raise AssertionError("K7 differs from K3, or a no-take row is ok")
    c_out = torch.empty((b, 256), dtype=torch.int32, device=dev)
    med = ab_turns({"K3": lambda: sampling.sample_in_ball_stream(stream, p.tau),
                    "K7": lambda: ball_exp.sample_in_ball_v1(stream, p.tau),
                    "c.zero_()": c_out.zero_})
    print(f"phase 6: K7's write floor: zeroing its output int32 [{b}, 256] takes {med['c.zero_()']:.4f} ms "
          f"on the device (K7 {med['K7']:.4f})")

    def k7_and_floor(n=20):
        for _ in range(n):
            ball_exp.sample_in_ball_v1(stream, p.tau)
            c_out.zero_()

    _, _, _, rest = round_profile.profile_call(k7_and_floor)
    if rest is None:
        print("phase 6: K7 and its write floor under torch.profiler: no device events recorded; not measured")
    else:
        print("phase 6: K7 and its write floor under torch.profiler (CUDA activity), device us a call of 20: "
              + "; ".join(f"{name[:70]} {us / 20:.2f}" for name, us in sorted(rest.items(), key=lambda kv: -kv[1])))
    answers.append((f"ball level 3 B={b} (primary)", {k: med[k] for k in ("K3", "K7")}))
    # then levels 2, 3 and 5 at the signer's window, the kernel bench's
    # batch, a lockstep round and a ragged batch, each with the stress rows
    # of `tools/ball_edges.py` (no-take rows and rows that end on the last
    # byte among them)
    for level in (2, 3, 5):
        p = get_params(level)
        nbytes = p.ball_blocks * SHAKE256_RATE
        edges = torch.from_numpy(ball_edges.edge_streams(p.tau, nbytes, seed=SEED + level)).to(dev)
        for b in (W_MAIN, bench_kernels.BALL_BATCH, 65536, 16421):
            stream = keccak.shake256(u8(b, 32), nbytes)
            stream[:edges.shape[0]] = edges
            compare("ball_bitplane", f"level {level} B={b}", lambda: ball_exp.sample_in_ball_v1(stream, p.tau),
                    lambda: ball_exp.sample_in_ball_v1_plain(stream, p.tau), ball_work(stream, p.tau),
                    time_plain=b == 16421, stream_work=ball_stream_work(b, nbytes))
            v1 = ball_exp.sample_in_ball_v1(stream, p.tau)
            k3_err = max_abs_err(v1, sampling.sample_in_ball_stream(stream, p.tau))
            if k3_err != 0.0:
                raise AssertionError(f"K7 differs from K3 at level {level} B={b}")
            rows[-1]["err"] = max(rows[-1]["err"], k3_err)
            med = ab_turns({"K3": lambda: sampling.sample_in_ball_stream(stream, p.tau),
                            "K7": lambda: ball_exp.sample_in_ball_v1(stream, p.tau)})
            answers.append((f"ball level {level} B={b}", med))
            print(f"phase 6: ball_bitplane == K3 level {level} B={b} ({edges.shape[0]} stress rows, "
                  f"ok rows {int(v1[1].sum())} of {b}); device ms in turns: K3 {med['K3']:.4f}, K7 {med['K7']:.4f}")
    print("phase 6: A/B answers (device ms, the faster side and by how much): " + "; ".join(
        f"{name}: " + ", ".join(f"{side} {ms:.4f}" for side, ms in med.items())
        + f" -> {min(med, key=med.get)} faster, {max(med.values()) / min(med.values()):.2f}x the slowest"
        for name, med in answers))

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    res = bench_kernels.run(N_STATES, N_POLYS, dev)
    torch.cuda.synchronize()
    launches = _kernels.launches()
    missing = [k for k in BENCH_KERNELS + ("sponge", "ball", "ntt") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernel-bench path launched no {missing} kernel")
    ab = {f"{name} {side}": [round(x, 4) for x in ms] for name, sides in res["ab"].items()
          for side, ms in sides.items()}
    print(f"phase 6: bench_kernels {N_STATES} states, {N_POLYS} polys in {time.perf_counter() - t:.1f} s; "
          f"launches {launches}; A/B ms per round {ab}; "
          f"rows {json.dumps({k: round(v['ms'], 4) for k, v in res['rows'].items()})}")
    return rows, launches


def counted(fn):
    """Run fn() with every kernel count set to 0 just before it and read
    just after -> (its result, {kernel: launches})."""
    from dilithium_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _kernels.launches()


def require(launches: dict, kernels, what: str) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing} kernel")


def rows_of(a) -> list:
    return [bytes(r) for r in np.asarray(a)]


def u8_rows(rows) -> np.ndarray:
    return np.stack([np.frombuffer(bytes(r), dtype=np.uint8) for r in rows])


def gate_level(level: int, dev) -> str:
    """Phase 8a at one level: the bytes API on the card against the oracle
    (see `api_gate`). Returns a summary."""
    from dilithium_tpu_torch import api, oracle, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import verify_cases

    p = get_params(level)
    g = np.random.default_rng(SEED + 80 + level)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    seeds = g.integers(0, 256, (N_GATE_KEYS, 32), dtype=np.uint8)
    pks, sks = api.keygen(level, [s.tobytes() for s in seeds], device=dev)
    pk_o, sk_o = oracle.keygen(level, seeds)
    if pks != rows_of(pk_o) or sks != rows_of(sk_o):
        raise AssertionError(f"phase 8a level {level}: api.keygen differs from oracle.keygen")
    msgs = [g.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in g.integers(0, 301, N_GATE)]
    ks = g.integers(0, N_GATE_KEYS, N_GATE)
    mus = api.compute_mu_many(sks[0][64:96], msgs)
    mus_k = api.compute_mu_many([sks[k][64:96] for k in ks], msgs)
    sig_o, att_o = oracle.sign(level, np.repeat(sk_o[:1], N_GATE, axis=0), mus)
    sig_k, att_k = oracle.sign(level, sk_o[ks], mus_k)
    pairs_k = list(zip(ks.tolist(), msgs))

    signers = {mode: api.Signer(level, sks[0], mode=mode, device=dev) for mode in ("mxu", "batch")}
    multi = api.MultiSigner(level, sks, device=dev)
    for name, sigs, want in (("api.sign", api.sign(level, sks[0], msgs, device=dev), sig_o),
                             ("Signer mxu", signers["mxu"].sign(msgs), sig_o),
                             ("Signer batch", signers["batch"].sign(msgs), sig_o),
                             ("MultiSigner", multi.sign(pairs_k), sig_k)):
        if sigs != rows_of(want):
            raise AssertionError(f"phase 8a level {level}: {name} differs from oracle.sign")
    # the scheme calls beneath, in bytes and attempts
    for name, res, want, att in (
            ("scheme.sign", scheme.sign(t(sk_o[0]), t(mus), p), sig_o, att_o),
            ("MxuSigner", signers["mxu"].signer(t(mus)), sig_o, att_o),
            ("sign_expanded", scheme.sign_expanded(signers["batch"].expanded, t(mus), p), sig_o, att_o),
            ("sign_stream_keys", scheme.sign_stream_keys(multi.expanded, t(ks), t(mus_k), p), sig_k, att_k)):
        if not (np.array_equal(res.sig.cpu().numpy(), want) and np.array_equal(res.attempts.cpu().numpy(), att)):
            raise AssertionError(f"phase 8a level {level}: {name} differs from oracle.sign in bytes or attempts")
    for name, sigs, want, pk_rows, mu_rows in (
            ("api.sign", api.sign(level, sks[0], msgs, randomized=True, device=dev), sig_o, pk_o[[0] * N_GATE], mus),
            ("Signer mxu", signers["mxu"].sign(msgs, randomized=True), sig_o, pk_o[[0] * N_GATE], mus),
            ("Signer batch", signers["batch"].sign(msgs, randomized=True), sig_o, pk_o[[0] * N_GATE], mus),
            ("MultiSigner", multi.sign(pairs_k, randomized=True), sig_k, pk_o[ks], mus_k)):
        if any(a == b for a, b in zip(sigs, rows_of(want))) or not oracle.verify(
                level, pk_rows, mu_rows, u8_rows(sigs)).all():
            raise AssertionError(f"phase 8a level {level}: a randomized {name} signature repeats the "
                                 f"deterministic one or fails oracle.verify")

    # valid pairs, a row of every corruption class (a corrupted mu becomes
    # another message) and a signature of the wrong length
    _, sk_f = oracle.keygen(level, g.integers(0, 256, (1, 32), dtype=np.uint8))
    mu_f = g.integers(0, 256, (1, 64), dtype=np.uint8)
    bad_sig, bad_mu, names = verify_cases.negative_cases(sig_o, mus, oracle.sign(level, sk_f, mu_f)[0][0],
                                                         mu_f[0], p, seed=SEED + level)
    msg_of = {m.tobytes(): msg for m, msg in zip(mus, msgs)}
    pairs = list(zip(msgs, rows_of(sig_o))) + [(msg_of.get(m.tobytes(), msgs[1] + b"!"), sg.tobytes())
                                              for sg, m in zip(bad_sig, bad_mu)]
    expect = oracle.verify(level, pk_o[[0] * len(pairs)], api.compute_mu_many(sks[0][64:96], [m for m, _ in pairs]),
                           u8_rows(sg for _, sg in pairs)).tolist()
    if expect != [True] * N_GATE + [False] * len(names):
        raise AssertionError(f"phase 8a level {level}: the oracle's answers are not as built")
    pairs.append((msgs[1], rows_of(sig_o)[1][:-1]))
    expect.append(False)
    verifiers = {mode: api.Verifier(level, pks[0], mode=mode, device=dev) for mode in ("mxu", "batch")}
    for name, got in (("api.verify", api.verify(level, pks[0], pairs, device=dev)),
                      ("Verifier mxu", verifiers["mxu"].verify(pairs)),
                      ("Verifier batch", verifiers["batch"].verify(pairs))):
        if got != expect:
            raise AssertionError(f"phase 8a level {level}: {name} differs from oracle.verify")
    # one verifier's staging buffers grown, reused in part and grown again
    # (batches of 8, 3, 12 and 8 pairs, each with a corrupted and the short
    # row), then shared by two threads with batches of their own
    batches = []
    for k, (n, off) in enumerate(((8, 0), (3, 10), (12, 20), (8, 40))):
        idx = [N_GATE + k % len(names)] + list(range(off, off + n - 2))
        idx.insert(n // 2, len(pairs) - 1)
        batches.append(([pairs[i] for i in idx], [expect[i] for i in idx]))
    for mode, verifier in verifiers.items():
        answers = [verifier.verify(b) for b, _ in batches]
        if answers != [want for _, want in batches]:
            raise AssertionError(f"phase 8a level {level}: Verifier {mode} over batches of 8, 3, 12 and 8 "
                                 f"differs from oracle.verify")
        start, wrong = threading.Barrier(2), []

        def run(b, want):
            start.wait()
            wrong.extend(got for got in (verifier.verify(b) for _ in range(6)) if got != want)

        threads = [threading.Thread(target=run, args=batches[i]) for i in (2, 3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if wrong or answers[0] != batches[0][1]:
            raise AssertionError(f"phase 8a level {level}: Verifier {mode} shared by two threads differs "
                                 f"from oracle.verify, or changed an earlier answer")

    with tempfile.TemporaryDirectory() as d:
        for mode in ("mxu", "batch"):
            path = os.path.join(d, f"key-{mode}")
            for cached in (False, True):  # the write, then the reload
                if os.path.exists(path + ".npz") != cached:
                    raise AssertionError(f"phase 8a level {level}: the {mode} cache file is not as expected")
                sigs = api.Signer(level, sks[0], mode=mode, cache_path=path, device=dev).sign(msgs)
                oks = api.Verifier(level, pks[0], mode=mode, cache_path=path + "-pk", device=dev).verify(pairs)
                if sigs != rows_of(sig_o) or oks != expect:
                    raise AssertionError(f"phase 8a level {level}: a {mode} service "
                                         f"{'loaded from' if cached else 'writing'} its cache differs")
    return (f"level {level}: keygen of {N_GATE_KEYS} keys, {N_GATE} messages of 0-300 bytes through api.sign, "
            f"Signer mxu/batch and MultiSigner ({N_GATE_KEYS} keys) == oracle.sign (bytes and attempts "
            f"beneath), randomized accepted and new; api.verify, Verifier mxu/batch == oracle.verify on "
            f"{N_GATE} valid, {len(names)} corrupted and 1 short row; Verifier mxu/batch over batches of 8, 3, "
            f"12 and 8 and shared by two threads == oracle.verify; caches written and reloaded")


def cli_gate() -> str:
    """Phase 8a, the CLI: `python -m dilithium_tpu_torch --level 3` in
    subprocesses on the card, in a temporary directory: keygen, sign and
    verify exit 0, and verify exits 1 once a signature byte is flipped;
    the files equal the oracle's keys and signatures."""
    from dilithium_tpu_torch import api, oracle

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(x for x in (repo, os.environ.get("PYTHONPATH")) if x))
    with tempfile.TemporaryDirectory() as d:
        def cli(*args):
            proc = subprocess.run([sys.executable, "-m", "dilithium_tpu_torch", "--level", "3", *args],
                                  cwd=repo, env=env, capture_output=True, text=True, timeout=600)
            return proc.returncode, proc.stderr[-2000:]

        seed, pk, sk = (os.path.join(d, n) for n in ("seed", "key.pk", "key.sk"))
        msgs = [os.path.join(d, n) for n in ("a", "b")]
        seed_b = bytes(range(32))
        for path, data in ((seed, seed_b), (msgs[0], b"chip smoke"), (msgs[1], bytes(range(256)) * 3)):
            with open(path, "wb") as f:
                f.write(data)
        runs = [cli("keygen", "--seed", seed, "--pk", pk, "--sk", sk), cli("sign", "--sk", sk, *msgs),
                cli("verify", "--pk", pk, *msgs)]
        pk_o, sk_o = oracle.keygen(3, np.frombuffer(seed_b, dtype=np.uint8)[None])
        with open(pk, "rb") as f1, open(sk, "rb") as f2:
            keys_ok = f1.read() == pk_o[0].tobytes() and f2.read() == sk_o[0].tobytes()
        contents = []
        for m in msgs:
            with open(m, "rb") as f:
                contents.append(f.read())
        sig_o, _ = oracle.sign(3, np.repeat(sk_o, 2, axis=0), api.compute_mu_many(sk_o[0, 64:96].tobytes(), contents))
        sigs = []
        for m in msgs:
            with open(m + ".sig", "rb") as f:
                sigs.append(f.read())
        flipped = bytearray(sigs[1])
        flipped[100] ^= 1
        with open(msgs[1] + ".sig", "wb") as f:
            f.write(bytes(flipped))
        runs.append(cli("verify", "--pk", pk, *msgs))
    codes = [rc for rc, _ in runs]
    if codes != [0, 0, 0, 1] or not keys_ok or sigs != rows_of(sig_o):
        raise AssertionError(f"phase 8a CLI: exit codes {codes} (want [0, 0, 0, 1]), keys equal the oracle's "
                             f"{keys_ok}, signatures equal {sigs == rows_of(sig_o)}; stderr {[e for _, e in runs]}")
    return "CLI level 3 on the card: keygen 0, sign 0, verify 0, verify after a flipped byte 1; files == oracle"


def check_sig(out) -> np.ndarray:
    """The signatures of a run: a list of bytes (the API) or a SignResult."""
    return u8_rows(out) if isinstance(out, list) else out.sig.cpu().numpy()


def full_run(name: str, fn, check):
    """Phase 8b: run fn() once counted (K1, K3 and K4 must launch) with its
    peak memory, check(result) -> (SignResult beneath, signatures as
    uint8 numpy), then 3 timed runs. -> (summary, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out, launches = counted(fn)
    t_first = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    require(launches, ("sponge", "ball", "ntt"), f"phase 8b {name}")
    res, sig = check(out)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if not np.array_equal(check_sig(again), sig):
        raise AssertionError(f"phase 8b {name}: a repeated run gave other signatures")
    rate = sig.shape[0] / statistics.median(times)
    att = res.attempts.cpu().numpy()
    return (f"{name}: {rate:.1f} signs/s (median of 3 runs {[round(x, 4) for x in times]} s; first run "
            f"{t_first:.3f} s), rounds {res.rounds}, mean attempts {att.mean():.4f}, max_memory_allocated "
            f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} above the resident); all {sig.shape[0]} ok and "
            f"verified by the oracle, {N_ORACLE_SIGN} equal oracle.sign in bytes and attempts; launches "
            f"{launches}"), launches, res


def oracle_gate(name, res, sig, pk_rows, sk_rows, mus) -> None:
    """Every signature ok and accepted by oracle.verify under its own key;
    the first N_ORACLE_SIGN equal oracle.sign in bytes and attempts."""
    from dilithium_tpu_torch import oracle

    if not bool(res.ok.all()):
        raise AssertionError(f"phase 8b {name}: {int((~res.ok).sum())} signatures not ok")
    if not oracle.verify(3, pk_rows, mus, sig).all():
        raise AssertionError(f"phase 8b {name}: the oracle rejects a signature")
    sig_o, att_o = oracle.sign(3, sk_rows[:N_ORACLE_SIGN], mus[:N_ORACLE_SIGN])
    if not (np.array_equal(sig[:N_ORACLE_SIGN], sig_o)
            and np.array_equal(res.attempts[:N_ORACLE_SIGN].cpu().numpy(), att_o)):
        raise AssertionError(f"phase 8b {name}: signatures differ from the oracle's")


def full_width(dev):
    """Phase 8b: the JAX package's bench operating points at Dilithium-3,
    full width: `keys` (MultiSigner of N_KEYS keys, Q_MAIN messages of
    MSG_LEN bytes from bytes), `stream` (one key, sign_stream) and
    `lockstep` (LOCKSTEP_Q keys, scheme.sign); then one profiled stream
    queue. -> ({kernel: launches of the three counted runs}, the `keys`
    and `lockstep` runs' inputs and results, for phase 9)."""
    from dilithium_tpu_torch import api, oracle, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import round_profile

    p = get_params(3)
    g = np.random.default_rng(SEED + 90)
    total = Counter()

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    # keys: raw message bytes -> compute_mu_many -> sign_stream_keys -> bytes
    seeds = g.integers(0, 256, (N_KEYS, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    pks, sks = api.keygen(3, [s.tobytes() for s in seeds], device=dev)
    multi = api.MultiSigner(3, sks, window=W_MAIN, device=dev)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t0
    pk_o, sk_o = oracle.keygen(3, seeds)
    if pks != rows_of(pk_o) or sks != rows_of(sk_o):
        raise AssertionError("phase 8b keys: api.keygen differs from oracle.keygen")
    ks = g.integers(0, N_KEYS, Q_MAIN)
    msgs = [m.tobytes() for m in g.integers(0, 256, (Q_MAIN, MSG_LEN), dtype=np.uint8)]
    pairs = list(zip(ks.tolist(), msgs))
    mus_k = api.compute_mu_many([sks[k][64:96] for k in ks], msgs)

    def check_keys(sigs):
        sig = u8_rows(sigs)
        res = scheme.sign_stream_keys(multi.expanded, t(ks), t(mus_k), p, window=W_MAIN)
        if not np.array_equal(res.sig.cpu().numpy(), sig):
            raise AssertionError("phase 8b keys: MultiSigner differs from sign_stream_keys beneath it")
        oracle_gate("keys", res, sig, pk_o[ks], sk_o[ks], mus_k)
        return res, sig

    line, launches, res_keys = full_run(
        f"keys ({N_KEYS} keys, {Q_MAIN} messages of {MSG_LEN} B, W={W_MAIN}, from bytes)",
        lambda: multi.sign(pairs), check_keys)
    keys = {"eks": multi.expanded, "key_idx": t(ks), "mus": t(mus_k), "res": res_keys}
    total.update(launches)
    print(f"phase 8b: {line}; key set-up (keygen + expand_sk of {N_KEYS}) {t_keys:.3f} s")

    # stream: one key, sign_stream over Q_MAIN mu
    t0 = time.perf_counter()
    ek = scheme.expand_sk(t(sk_o[0]), p)
    torch.cuda.synchronize()
    t_ek = time.perf_counter() - t0
    mus = g.integers(0, 256, (Q_MAIN, 64), dtype=np.uint8)
    mus_t = t(mus)

    def stream():
        return scheme.sign_stream(ek, mus_t, p, window=W_MAIN)

    def check_stream(res):
        sig = res.sig.cpu().numpy()
        oracle_gate("stream", res, sig, pk_o[[0] * Q_MAIN], sk_o[[0] * Q_MAIN], mus)
        return res, sig

    line, launches, _ = full_run(f"stream (one key, Q={Q_MAIN}, W={W_MAIN})", stream, check_stream)
    total.update(launches)
    print(f"phase 8b: {line}; expand_sk {t_ek:.4f} s")
    res, us, busy, rest = round_profile.profile_call(stream)
    if not bool(res.ok.all()):
        raise AssertionError("phase 8b: the profiled stream queue left a signature not ok")
    if us is None:
        print("phase 8b: profile: the profiler recorded no device events; device breakdown not measured")
    else:
        groups = ", ".join(f"{gr} {v / res.rounds:.1f} us" for gr, v in us.items() if v)
        print(f"phase 8b: profile of one stream queue (torch.profiler, CUDA activity): device time per round "
              f"({res.rounds} rounds) {groups}; total {sum(us.values()) / res.rounds:.1f} us; busy share {busy:.4f}")
        top = sorted(rest.items(), key=lambda kv: -kv[1])[:TOP_REST]
        print(f"phase 8b: the rest's {TOP_REST} largest kernels of {len(rest)}, us per round: "
              + "; ".join(f"{v / res.rounds:.1f} {n[:90]}" for n, v in top))

    # lockstep: LOCKSTEP_Q independent keys, scheme.sign (expand_sk inside)
    seeds = g.integers(0, 256, (LOCKSTEP_Q, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    kp = scheme.keygen(t(seeds), p)
    torch.cuda.synchronize()
    t_kg = time.perf_counter() - t0
    pk_l, sk_l = kp.pk.cpu().numpy(), kp.sk.cpu().numpy()
    t0 = time.perf_counter()
    pk_o, sk_o = oracle.keygen(3, seeds)
    t_okg = time.perf_counter() - t0
    if not (bool(kp.ok.all()) and np.array_equal(pk_l, pk_o) and np.array_equal(sk_l, sk_o)):
        raise AssertionError(f"phase 8b lockstep: keygen of {LOCKSTEP_Q} keys differs from oracle.keygen")
    mus = g.integers(0, 256, (LOCKSTEP_Q, 64), dtype=np.uint8)
    mus_t = t(mus)

    def check_lockstep(res):
        sig = res.sig.cpu().numpy()
        oracle_gate("lockstep", res, sig, pk_l, sk_l, mus)
        return res, sig

    line, launches, res_lockstep = full_run(
        f"lockstep ({LOCKSTEP_Q} keys, attempts_per_round={ATTEMPTS}, max_rounds={LOCKSTEP_ROUNDS})",
        lambda: scheme.sign(kp.sk, mus_t, p, attempts_per_round=ATTEMPTS, max_rounds=LOCKSTEP_ROUNDS),
        check_lockstep)
    total.update(launches)
    print(f"phase 8b: {line}; keygen of {LOCKSTEP_Q} keys {t_kg:.3f} s, all equal oracle.keygen "
          f"({t_okg:.3f} s on the host); card {card_line()}")
    lockstep = {"seeds": t(seeds), "kp": kp, "mus": mus_t, "res": res_lockstep}
    return total, {"keys": keys, "lockstep": lockstep}


def kat_gate(dev) -> str:
    """Phase 8a, the KAT replay (`tools/kat_replay.replay`) at levels 2, 3
    and 5 on the card, when DILITHIUM_KAT_DIR names a directory."""
    kat_dir = os.environ.get("DILITHIUM_KAT_DIR")
    if not (kat_dir and os.path.isdir(kat_dir)):
        return (f"KAT replay: not run, DILITHIUM_KAT_DIR ({kat_dir!r}) names no directory "
                f"(the corpus is not in the repository)")
    from dilithium_tpu_torch.tools import kat_replay

    out = kat_replay.replay(device=dev)
    if out["kat"] != "ok":
        raise AssertionError(f"phase 8a: the KAT replay failed: {out['failed']}")
    return (f"KAT replay of {kat_dir}: {out['vectors_per_level']} vectors a level at levels {out['levels']}, "
            f"all {out['checks']} checks byte-equal on the card")


def api_path(dev):
    """Phase 8: the gate (8a) and the full-width signer runs (8b).
    -> ({kernel: launches of phase 8's counted runs}, phase 8b's runs)."""
    total = Counter()
    for level in (2, 3, 5):
        line, launches = counted(lambda: gate_level(level, dev))
        require(launches, MAIN_KERNELS, f"phase 8a level {level}")
        total.update(launches)
        print(f"phase 8a: {line}; launches {launches}")
    print(f"phase 8a: {cli_gate()}")
    print(f"phase 8a: {kat_gate(dev)}")
    launches, runs = full_width(dev)
    total.update(launches)
    return total, runs


def same_result(name: str, got, want) -> None:
    """A sharded SignResult equals the phase's SignResult in sig,
    attempts and ok, and its global counters equal the sums of its local
    outputs (a world of one rank)."""
    for field in ("sig", "attempts", "ok"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"phase 9a {name}: {field} differs from the phase it is held to")
    if (int(got.total_signed), int(got.total_attempts)) != (int(got.ok.sum()), int(got.attempts.sum())):
        raise AssertionError(f"phase 9a {name}: the all-reduced counters differ from the local sums")


def same_answers(name: str, got, want: np.ndarray) -> None:
    ok, total = got
    if not np.array_equal(ok.cpu().numpy(), want) or int(total) != int(want.sum()):
        raise AssertionError(f"phase 9a {name}: accept/reject or total differs from phase 7's answers")


def parallel_path(main, ver, full, dev) -> Counter:
    """Phase 9a: every service of `dilithium_tpu_torch.parallel` in a
    world of one rank (NCCL on the card, a FileStore in a temporary
    directory), on the inputs of phases 5, 7 and 8b and equal to their
    results; each service's checked run counted, then timed in turns with
    the single-card call beneath it (direct, service, service, direct,
    direct, service). -> {kernel: launches of the checked runs}."""
    import torch.distributed as dist

    from dilithium_tpu_torch import mxu, scheme
    from dilithium_tpu_torch.parallel import (
        initialize, make_mesh, sharded_keygen, sharded_sign, sharded_sign_stream,
        sharded_sign_stream_keys, sharded_verify, sharded_verify_stream,
    )
    from dilithium_tpu_torch.params import get_params

    p = get_params(3)
    keys, lock = full["keys"], full["lockstep"]
    sk, pk, ops, mus, res5 = main["sk"], main["pk"], main["ops"], main["mus"], main["res"]
    sig_v, mu_v, expect = ver["sig"], ver["mu"], ver["expect"]
    lane_sig, lane_mu = ver["lane_rows"]
    total = Counter()
    with tempfile.TemporaryDirectory() as d:
        initialize(coordinator=f"file://{d}/store", num_processes=1, process_id=0, device=dev)
        try:
            mesh = make_mesh(dev)
            backend = dist.get_backend()
            ek = scheme.expand_sk(sk, p)
            stream = {m: sharded_sign_stream(mesh, p, window=W_MAIN, use_mxu=m) for m in (True, False)}
            vstream = {m: sharded_verify_stream(mesh, p, use_mxu=m) for m in (True, False)}
            kg = sharded_keygen(mesh, p)
            lane_sign = sharded_sign(mesh, p, attempts_per_round=ATTEMPTS, max_rounds=LOCKSTEP_ROUNDS)
            rep_sign = sharded_sign(mesh, p, replicate_key=True)
            lane_verify, rep_verify = sharded_verify(mesh, p), sharded_verify(mesh, p, replicate_key=True)
            keys_svc = sharded_sign_stream_keys(mesh, p, window=W_MAIN)
            lane_pk = pk.expand(lane_sig.shape[0], -1)

            def check_keygen(out):
                if not (torch.equal(out[0], lock["kp"].pk) and torch.equal(out[1], lock["kp"].sk)
                        and bool(out[2].all())):
                    raise AssertionError("phase 9a sharded_keygen: pk or sk differs from phase 8b lockstep's")

            # name, unit, rows, service call, the single-card call beneath it, check
            runs = [
                ("sharded_sign_stream(use_mxu=True)", "signs", Q_MAIN, lambda: stream[True](ops, mus),
                 lambda: mxu.sign_stream_mxu(ops, mus, p, window=W_MAIN, max_rounds=8192),
                 lambda r: same_result("sharded_sign_stream mxu", r, res5)),
                ("sharded_sign_stream(use_mxu=False)", "signs", Q_MAIN, lambda: stream[False](ek, mus),
                 lambda: scheme.sign_stream(ek, mus, p, window=W_MAIN, max_rounds=8192),
                 lambda r: same_result("sharded_sign_stream generic", r, res5)),
                (f"sharded_sign_stream_keys ({N_KEYS} keys)", "signs", Q_MAIN,
                 lambda: keys_svc(keys["eks"], keys["key_idx"], keys["mus"]),
                 lambda: scheme.sign_stream_keys(keys["eks"], keys["key_idx"], keys["mus"], p, window=W_MAIN),
                 lambda r: same_result("sharded_sign_stream_keys", r, keys["res"])),
                (f"sharded_keygen ({LOCKSTEP_Q} seeds)", "keys", LOCKSTEP_Q, lambda: kg(lock["seeds"]),
                 lambda: scheme.keygen(lock["seeds"], p), check_keygen),
                (f"sharded_sign, a key a lane (A={ATTEMPTS}, max_rounds={LOCKSTEP_ROUNDS})", "signs", LOCKSTEP_Q,
                 lambda: lane_sign(lock["kp"].sk, lock["mus"]),
                 lambda: scheme.sign(lock["kp"].sk, lock["mus"], p, ATTEMPTS, LOCKSTEP_ROUNDS),
                 lambda r: same_result("sharded_sign per lane", r, lock["res"])),
                ("sharded_sign(replicate_key=True)", "signs", Q_MAIN, lambda: rep_sign(sk, mus),
                 lambda: scheme.sign(sk, mus, p), lambda r: same_result("sharded_sign replicate_key", r, res5)),
                ("sharded_verify_stream(use_mxu=True)", "verifies", sig_v.shape[0],
                 lambda: vstream[True](ver["vops"], sig_v, mu_v),
                 lambda: mxu.verify_mxu(ver["vops"], sig_v, mu_v, p),
                 lambda r: same_answers("sharded_verify_stream mxu", r, expect)),
                ("sharded_verify_stream(use_mxu=False)", "verifies", sig_v.shape[0],
                 lambda: vstream[False](ver["epk"], sig_v, mu_v),
                 lambda: scheme.verify_expanded(ver["epk"], sig_v, mu_v, p),
                 lambda r: same_answers("sharded_verify_stream generic", r, expect)),
                ("sharded_verify, a key a lane", "verifies", lane_sig.shape[0],
                 lambda: lane_verify(lane_pk, lane_sig, lane_mu),
                 lambda: scheme.verify(lane_pk, lane_sig, lane_mu, p),
                 lambda r: same_answers("sharded_verify per lane", r, ver["expect_lane"])),
                ("sharded_verify(replicate_key=True)", "verifies", sig_v.shape[0],
                 lambda: rep_verify(pk, sig_v, mu_v),
                 lambda: scheme.verify_expanded(scheme.expand_pk(pk, p), sig_v, mu_v, p),
                 lambda r: same_answers("sharded_verify replicate_key", r, expect)),
            ]
            for name, unit, rows, service, direct, check in runs:
                out, launches = counted(service)
                check(out)
                total.update(launches)
                times = {"service": [], "direct": []}
                for side in ("direct", "service", "service", "direct", "direct", "service"):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    (service if side == "service" else direct)()
                    torch.cuda.synchronize()
                    times[side].append(time.perf_counter() - t)
                rate = {side: rows / statistics.median(ts) for side, ts in times.items()}
                print(f"phase 9a: {name} on {rows} rows == its phase; service {rate['service']:.1f} {unit}/s, "
                      f"single-card call {rate['direct']:.1f} {unit}/s (medians of 3 in turns: service "
                      f"{[round(x, 4) for x in times['service']]} s, direct {[round(x, 4) for x in times['direct']]} "
                      f"s); launches {launches}")
        finally:
            dist.destroy_process_group()
    require(total, MAIN_KERNELS, "phase 9a")
    print(f"phase 9a: a world of one rank, {backend} on {dev}: every service == phases 5, 7 and 8b; launches {dict(total)}; "
          f"card {card_line()}")
    return total


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launcher_path() -> None:
    """Phase 9b: `python -m dilithium_tpu_torch.tools.run_multihost`, one
    process per visible card over NCCL, Dilithium-3: the dense-operator
    signer at 16384 messages a card with --verify, and --signer keys
    --nkeys 1 --verify at 2048 a card. Every process must report the
    global counters (signed == verified == the global batch, the same
    attempts); the concatenated shards must all be accepted by
    oracle.verify under the launcher's key (--seed 0), and the first
    N_ORACLE_SIGN equal oracle.sign."""
    from dilithium_tpu_torch import oracle

    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = entry_env()
    for flags, per_card in ((["--signer=mxu", "--verify"], Q_MAIN),
                            (["--signer=keys", "--nkeys=1", "--verify"], 2048)):
        batch = per_card * n
        port = free_port()
        with tempfile.TemporaryDirectory() as d:
            procs = [subprocess.Popen(
                [sys.executable, "-m", "dilithium_tpu_torch.tools.run_multihost", "--level=3",
                 f"--coordinator=127.0.0.1:{port}", f"--num-processes={n}", f"--process-id={i}",
                 f"--global-batch={batch}", *flags, f"--out={os.path.join(d, f'shard_{i}.npy')}"],
                cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(n)]
            try:
                outs = [proc.communicate(timeout=600) for proc in procs]
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            for proc, (out, err) in zip(procs, outs):
                if proc.returncode != 0:
                    raise AssertionError(f"phase 9b {' '.join(flags)}: a launcher exited {proc.returncode}: "
                                         f"{err[-3000:]}")
            reports = [json.loads(next(ln for ln in reversed(out.splitlines()) if ln.startswith("{")))
                       for out, _ in outs]
            shards = np.concatenate([np.load(os.path.join(d, f"shard_{i}.npy")) for i in range(n)])
        if any((r["signed"], r["verified"], r["global_batch"]) != (batch, batch, batch) for r in reports) \
                or len({r["attempts"] for r in reports}) != 1:
            raise AssertionError(f"phase 9b {' '.join(flags)}: the processes' counters are not global: {reports}")
        rng = np.random.default_rng(0)  # the launcher's derivation at --seed 0
        pk_o, sk_o = oracle.keygen(3, rng.integers(0, 256, (1, 32), dtype=np.uint8))
        mus = rng.integers(0, 256, (batch, 64), dtype=np.uint8)
        if not oracle.verify(3, np.repeat(pk_o, batch, axis=0), mus, shards).all():
            raise AssertionError(f"phase 9b {' '.join(flags)}: the oracle rejects a signature of the shards")
        sig_o, _ = oracle.sign(3, np.repeat(sk_o, N_ORACLE_SIGN, axis=0), mus[:N_ORACLE_SIGN])
        if not np.array_equal(shards[:N_ORACLE_SIGN], sig_o):
            raise AssertionError(f"phase 9b {' '.join(flags)}: the shards differ from oracle.sign")
        print(f"phase 9b: run_multihost {' '.join(flags)} --global-batch={batch}, {n} process(es) over NCCL: "
              f"signed == verified == {batch} in every process, attempts {reports[0]['attempts']}; all "
              f"{batch} accepted by oracle.verify, {N_ORACLE_SIGN} == oracle.sign; per process elapsed_s "
              f"{[r['elapsed_s'] for r in reports]}, signs_per_sec {[r['signs_per_sec'] for r in reports]} "
              f"(first call, key expansion included)"
              + ("; one card: no cross-card all-reduce ran" if n == 1 else f"; across {n} cards"))


BENCH_ITERS = 3  # bench.py's three blocks of one call each
# phase 10's bench.py runs: every mode at level 3, the dense signer and
# verify at levels 2 and 5
BENCH_RUNS = [(3, mode) for mode in ("mxu", "serve", "keys", "stream", "batch", "verify")] + [
    (level, mode) for level in (2, 5) for mode in ("mxu", "verify")]
SWEEP_WINDOWS = (512, 768, 1024, 1536)
ENTRY_KERNELS = ("sponge", "mask_limbs", "ball", "ntt", "permute")
# bench.py's diagnostics that phase 10 prints beside a mode's line
BENCH_NOTES = ("set-up", "first call", "peak memory", "serve:")


def entry_env(**extra) -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(x for x in (repo, os.environ.get("PYTHONPATH")) if x),
                **{k: str(v) for k, v in extra.items()})


def launches_in(stderr: str) -> tuple:
    """The sums of an entry point's `launches {...}` and `shapes [...]`
    lines (`bench.log_launches`) -> (Counter by kernel, Counter by shape)."""
    total, shapes = Counter(), Counter()
    for ln in stderr.splitlines():
        if ln.startswith("launches "):
            total.update(json.loads(ln[len("launches "):]))
        elif ln.startswith("shapes "):
            shapes.update({tuple(k[:-1]): k[-1] for k in json.loads(ln[len("shapes "):])})
    return total, shapes


def last_json(out: str):
    return json.loads(next((ln for ln in reversed(out.splitlines()) if ln.startswith("{")), "null"))


def entry_point(args, what: str, timeout: int = 900, **env):
    """`python -m <args>` from the repo root, to its end -> (its last JSON
    line, the finished process). Raises when it exits non-zero or its
    line has no value where it should."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=os.path.dirname(os.path.abspath(__file__)),
                          env=entry_env(**env), capture_output=True, text=True, timeout=timeout)
    line = last_json(proc.stdout)
    if proc.returncode != 0 or line is None or ("value" in line and line["value"] is None):
        raise AssertionError(f"phase 10 {what}: exit {proc.returncode}, line {line}: {proc.stderr[-3000:]}")
    return line, proc


def entry_points_path() -> Counter:
    """Phase 10: the port's measurement entry points at full width, each
    in its own process: `dilithium_tpu_torch.bench` in every mode at
    level 3 and in mxu and verify at levels 2 and 5 (3 timed blocks of one
    call each, its gate on), the window sweep at level 3, `bench_round` at
    W = 768, `bench_components` at B = 1024 with its latencies, both
    stage profiles and `bench_scaling` over the visible cards. Returns
    the launches the entry points report, by kernel and by shape; K1-K5
    must have launched."""
    torch.cuda.empty_cache()
    total, shapes = Counter(), Counter()

    def add(stderr: str) -> None:
        by_kernel, by_shape = launches_in(stderr)
        total.update(by_kernel)
        shapes.update(by_shape)

    t = time.perf_counter()
    for level, mode in BENCH_RUNS:
        line, proc = entry_point(["dilithium_tpu_torch.bench"], f"bench {mode} level {level}",
                                 DILITHIUM_BENCH_MODE=mode, DILITHIUM_BENCH_LEVEL=level,
                                 DILITHIUM_BENCH_ITERS=BENCH_ITERS)
        add(proc.stderr)
        blocks = line["blocks"]
        notes = [ln for ln in proc.stderr.splitlines() if ln.startswith(BENCH_NOTES)]
        print(f"phase 10: bench {mode} level {level}: {line['value']} {line['unit']} ({line['device']}, "
              f"{line['power_limit_w']} W), over the window {line['window_value']}, blocks {blocks}, "
              f"spread (max - min) / value "
              f"{(max(blocks) - min(blocks)) / line['value']:.1%}; {'; '.join(notes)}")

    sweep, proc = entry_point(["dilithium_tpu_torch.tools.sweep_window", "3", *map(str, SWEEP_WINDOWS)],
                              "sweep_window", timeout=1800, DILITHIUM_BENCH_ITERS=BENCH_ITERS)
    add(proc.stderr)
    blocks = {ln.split()[0]: json.loads(ln.split(" ", 1)[1])["blocks"]
              for ln in proc.stdout.splitlines() if ln.startswith("W=") and " {" in ln}
    print(f"phase 10: sweep_window level 3 (bench mxu, {BENCH_ITERS} blocks of one call): signs/sec "
          f"{sweep['values']}, best W = {sweep['best_window']}; blocks {blocks}")

    line, proc = entry_point(["dilithium_tpu_torch.bench_round", str(W_MAIN)], "bench_round")
    add(proc.stderr)
    print(f"phase 10: bench_round W={W_MAIN}: {json.dumps(line)}")
    line, proc = entry_point(["dilithium_tpu_torch.bench_components", "1024"], "bench_components")
    add(proc.stderr)
    print(f"phase 10: bench_components B=1024 ({line['device']}), ms a call: {json.dumps(line['ms'])}")
    line, proc = entry_point(["dilithium_tpu_torch.tools.profile_sign", str(W_MAIN), "3"], "profile_sign")
    add(proc.stderr)
    print(f"phase 10: profile_sign W={W_MAIN} level 3, us a round (back to back; device only): "
          f"{json.dumps(line['us_per_round'])}; {json.dumps(line['device_us_per_round'])}")
    line, proc = entry_point(["dilithium_tpu_torch.tools.profile_verify", str(Q_MAIN)], "profile_verify")
    add(proc.stderr)
    print(f"phase 10: profile_verify B={Q_MAIN} level 3, ms a call (back to back; device only): "
          f"{json.dumps(line['ms'])}; {json.dumps(line['device_ms'])}")

    n = torch.cuda.device_count()
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dilithium_tpu_torch.bench_scaling", f"--coordinator=127.0.0.1:{port}",
         f"--num-processes={n}", f"--process-id={i}"], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=entry_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(n)]
    try:
        outs = [proc.communicate(timeout=900) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"phase 10 bench_scaling: a rank exited {proc.returncode}: {err[-3000:]}")
        add(err)
    print(f"phase 10: bench_scaling over {n} card(s): {json.dumps(last_json(outs[0][0]))}")
    require(total, ENTRY_KERNELS, "phase 10")
    print(f"phase 10: {time.perf_counter() - t:.1f} s; launches the entry points report {dict(total)} "
          f"at {len(shapes)} shapes")
    return total, shapes


def shape_case(key, g, dev):
    """Inputs for one `_kernels.SHAPES` key, drawn from g -> (label, fn,
    plain_fn, work, stream_work)."""
    from dilithium_tpu_torch.ops import keccak, ntt, sampling
    from dilithium_tpu_torch.params import get_params

    def u8(*shape):
        return torch.from_numpy(g.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    kernel, *args = key
    if kernel == "sponge":
        b, n, out, rate, domain = args
        msg = u8(b, n)
        return (f"[{b}, {n}] -> {out} rate {rate} domain {domain:#x}",
                lambda: keccak.sponge(msg, out, rate, domain), lambda: keccak.sponge_plain(msg, out, rate, domain),
                sponge_work(b, n, out, rate), None)
    if kernel == "mask_limbs":
        W, L, bits, _ = args
        level = next(lv for lv in (2, 3, 5) if (get_params(lv).L, get_params(lv).gamma1_bits) == (L, bits))
        lp = get_params(level)
        rp = u8(W, 64)
        kappa = torch.from_numpy(g.integers(0, 400, W).astype(np.int32) * L).to(dev)
        return (f"level {level} W={W} L={L}", lambda: sampling.expand_mask_limbs(rp, kappa, lp),
                lambda: sampling.mask_limbs_plain(rp, kappa, lp),
                (W * (64 + 4 + 3 * L * 256), W * L * sponge_work(1, 66, lp.polyz_packedbytes, 136)[1]), None)
    if kernel == "ball":
        b, tau, nbytes = args
        st = u8(b, nbytes)
        return (f"tau {tau} B={b} {nbytes} B", lambda: sampling.sample_in_ball_stream(st, tau),
                lambda: sampling.sample_in_ball_plain(st, tau), ball_work(st, tau), ball_stream_work(b, nbytes))
    if kernel == "ntt":
        b, inverse, scale, _ = args
        x = torch.from_numpy(g.integers(0, 8380417, (b, 256)).astype(np.int32)).to(dev)
        if not inverse:
            return f"forward [{b}, 256]", lambda: ntt.ntt(x), lambda: ntt.ntt_plain(x), ntt_work(b, False), None
        fp = scale == ntt._SCALE_PRODUCT
        return (f"inverse {'product' if fp else 'plain'} [{b}, 256]", lambda: ntt.invntt(x, fp),
                lambda: ntt.invntt_plain(x, fp), ntt_work(b, True), None)
    if kernel == "permute":
        b, state_stride, _ = args
        st = torch.from_numpy(g.integers(-(1 << 63), 1 << 63, (b, 25), dtype=np.int64)).to(dev)
        work = (b * 400, b * PERM_OPS)
        if state_stride == 25:
            return f"[{b}, 25]", lambda: keccak.keccak_f1600(st), lambda: keccak.keccak_f1600_plain(st), work, None
        planes = st.t().contiguous()
        return (f"planes [25, {b}]", lambda: keccak.keccak_f1600_planes(planes),
                lambda: keccak.keccak_f1600_plain(st).t(), work, None)
    raise AssertionError(f"phase 10b: no inputs for {kernel} at {args}")


def check_entry_shapes(shapes: Counter, covered: set, dev, int_ops) -> list:
    """Phase 10b: every shape phase 10's entry points launched that no row
    of phases 3 and 6 ran, held against its plain version, bit-equal, on
    inputs from a generator of its own -> the rows."""
    rows = []
    compare = comparer("phase 10b", rows, int_ops)
    g = np.random.default_rng(SEED + 10)
    missing = sorted(set(shapes) - covered)
    t = time.perf_counter()
    for key in missing:
        label, fn, plain_fn, work, stream_work = shape_case(key, g, dev)
        compare(key[0], f"{label} ({shapes[key]} launches in phase 10)", fn, plain_fn, work,
                time_plain=False, stream_work=stream_work)
        if key not in rows[-1]["shapes"]:
            raise AssertionError(f"phase 10b: the row for {key} launched {rows[-1]['shapes']}")
        torch.cuda.empty_cache()
    print(f"phase 10b: of the {len(shapes)} shapes phase 10 launched, {len(shapes) - len(missing)} were held "
          f"by phases 3 and 6, the other {len(missing)} here, all bit-equal, in {time.perf_counter() - t:.1f} s")
    return rows


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # no buffered line is left for a child to repeat
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from dilithium_tpu_torch import _kernels

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t = time.perf_counter()
    lib = _kernels.build()
    _kernels.library()
    with open(lib + ".log") as f:
        ptxas = [ln.strip() for ln in f if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"phase 2: built {lib} in {time.perf_counter() - t:.1f} s; ptxas: {' | '.join(ptxas)}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    int_ops = sms * INT32_PER_SM_CLOCK * clock
    print(f"bounds: {MEM_BYTES_PER_S / 1e12} TB/s; {sms} SMs x {INT32_PER_SM_CLOCK} INT32 lanes x "
          f"{clock / 1e6:.0f} MHz (clocks.max.sm) = {int_ops / 1e12:.3f} T int32 ops/s")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    rows = check_kernels(rng, dev, int_ops)
    check_other_device()
    check_small_slice(rng, dev)
    check_small_verify(dev)
    launches, main = main_path(rng, dev)
    bench_rows, bench_launches = check_bench_path(rng, dev, int_ops)
    verify_launches, ver = verify_path(main, dev)
    api_launches, full = api_path(dev)
    t = time.perf_counter()
    parallel_launches = parallel_path(main, ver, full, dev)
    launcher_path()
    print(f"phase 9: {time.perf_counter() - t:.1f} s")
    entry_launches, entry_shapes = entry_points_path()
    rows += bench_rows
    # rows that hold a kernel against another kernel (K6 vs K1) cover no shape
    rows += check_entry_shapes(entry_shapes, set().union(*(r.get("shapes", ()) for r in rows)), dev, int_ops)
    launches.update({k: bench_launches[k] for k in BENCH_KERNELS})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        primary = next(r for r in mine if r["primary"])
        bound_ms, bound_by = bound(primary["work"], int_ops)
        # SampleInBall's second bound: the whole stream read, as earlier runs counted it
        stream_bound = {}
        if primary.get("stream_work") is not None:
            stream_ms = bound(primary["stream_work"], int_ops)[0]
            stream_bound = {"bound_stream_ms": stream_ms, "share_stream": stream_ms / primary["device_ms"]}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "verify_launches": verify_launches[name],
            "api_launches": api_launches[name], "parallel_launches": parallel_launches[name],
            "entry_launches": entry_launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": primary["ms"], "device_ms": primary["device_ms"], "plain_ms": primary["plain_ms"],
            "bound_ms": bound_ms, "share": bound_ms / primary["device_ms"],
            "bound_by": bound_by, "library_ms": None, "shape": primary["shape"], **stream_bound,
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
