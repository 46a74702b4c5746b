#!/usr/bin/env python3
"""Drive the PyTorch port's one-key Dilithium signing and verify paths and
its kernel micro-bench on one CUDA card.

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
     [81920, 256] and inverse on [98304, 256]); each row with the median
     CUDA-event time of one call (`ms`, host time included at small
     shapes), the device-only time of one call (`device_ms`,
     `bench_kernels.device_ms`) and its bound;
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
     K7 (bit-plane SampleInBall) against their plain versions, bit-equal,
     K6 also against K1 and K7 against K3; then
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
Then one JSON line with every kernel's launches (phase 5 for K1-K4,
phase 6 for K5-K7; `verify_launches` from phase 7), error, time,
device-only time, plain time and bound, the card line again, and last
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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 2026
Q_MAIN, W_MAIN = 16384, 768
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


def ball_work(batch: int, nbytes: int):
    """(bytes, ops) of SampleInBall: the stream read, c (int32) and ok
    written; ops count one per output coefficient only (a lower bound)."""
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
    against plain_fn bit for bit, time both, and append a row."""
    from dilithium_tpu_torch.bench_kernels import device_ms

    def compare(kernel, label, fn, plain_fn, work, primary=False):
        got, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0.0:
            raise AssertionError(f"{kernel} {label} differs from its plain version")
        ms, dev_ms, plain_ms = time_ms(fn), device_ms(fn), time_ms(plain_fn)
        bound_ms, bound_by = bound(work, int_ops)
        print(f"{phase}: {kernel} {label}: max_abs_err {err} kernel {ms:.4f} ms device {dev_ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound_ms:.6f} ms ({bound_by}, {bound_ms / dev_ms:.2%} of device)")
        rows.append({"kernel": kernel, "shape": label, "err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "work": work, "primary": primary})
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
            lambda: sampling.sample_in_ball_plain(stream, p.tau), ball_work(W_MAIN, 272), primary=True)
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
                    lambda: sampling.sample_in_ball_plain(st, tau), ball_work(b, nbytes))

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
    """Phase 5: the main path at full size, counted, checked and timed."""
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
    launches = dict(_kernels.LAUNCHES)
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
    return launches, kp.pk, mus_np, sig


def verify_path(pk, mus_np, sig_np, dev):
    """Phase 7: one-key verify at full width, Dilithium-3, phase 5's key
    and its Q_MAIN signatures plus a block of corrupted rows: the three
    verifiers against the oracle, counted; verifies/s of `verify_mxu` and
    `verify_expanded`; one profiled `verify_mxu` call."""
    from dilithium_tpu_torch import _kernels, mxu, oracle, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.tools import round_profile

    p = get_params(3)
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
    launches = dict(_kernels.LAUNCHES)
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
    return launches


def check_bench_path(rng, dev, int_ops):
    """Phase 6: K5-K7 against their plain versions (K6 also against K1,
    K7 against K3), then the kernel bench at full width, counted."""
    from dilithium_tpu_torch import _kernels, bench_kernels
    from dilithium_tpu_torch.ops import keccak, sampling
    from dilithium_tpu_torch.params import SHAKE256_RATE, get_params
    from dilithium_tpu_torch.tools import ball_exp, xof_exp

    rows = []
    compare = comparer("phase 6", rows, int_ops)

    def lanes(b):
        return torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, (b, 25), dtype=np.int64)).to(dev)

    planes = lanes(N_STATES).t().contiguous()
    compare("permute", f"planes [25, {N_STATES}]", lambda: keccak.keccak_f1600_planes(planes),
            lambda: keccak.keccak_f1600_plain(planes.t().contiguous()).t(),
            (N_STATES * 400, N_STATES * PERM_OPS), primary=True)
    st = lanes(16421)  # a batch that is not a multiple of the block
    compare("permute", "[16421, 25]", lambda: keccak.keccak_f1600(st),
            lambda: keccak.keccak_f1600_plain(st), (st.shape[0] * 400, st.shape[0] * PERM_OPS))

    xb = bench_kernels.XOF_BATCH
    msgs = torch.from_numpy(rng.integers(0, 256, (xb, 66), dtype=np.uint8)).to(dev)
    xp = xof_exp.planes_for(msgs, SHAKE256_RATE)
    rate_w = SHAKE256_RATE // 8
    compare("sponge_planes", f"[{xp.shape[0]}, {xb}] -> [{xb}, 160]",
            lambda: xof_exp.shake_words_batchmajor(xp, 160, rate_w),
            lambda: xof_exp.shake_words_batchmajor_plain(xp, 160, rate_w),
            (xb * (xp.shape[0] * 4 + 160 * 4), sponge_work(xb, 66, 640, SHAKE256_RATE)[1]), primary=True)
    k1_err = max_abs_err(xof_exp.xof_bm(msgs, 160, SHAKE256_RATE), keccak.shake_words(msgs, 160, SHAKE256_RATE))
    print(f"phase 6: sponge_planes (planes_for + K6) vs K1 shake_words [{xb}, 66] -> 160 words: max_abs_err {k1_err}")
    if k1_err != 0.0:
        raise AssertionError("K6 differs from K1")
    rows[-1]["err"] = max(rows[-1]["err"], k1_err)

    p = get_params(3)
    for b, primary in ((bench_kernels.BALL_BATCH, True), (W_MAIN, False)):
        c_tilde = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
        stream = keccak.shake256(c_tilde, p.ball_blocks * SHAKE256_RATE)
        stream[:4, 8:] = 255  # no candidate taken: ok = 0, the j = 0 fill path
        compare("ball_bitplane", f"B={b}", lambda: ball_exp.sample_in_ball_v1(stream, p.tau),
                lambda: ball_exp.sample_in_ball_v1_plain(stream, p.tau),
                ball_work(b, stream.shape[1]), primary=primary)
        v1 = ball_exp.sample_in_ball_v1(stream, p.tau)
        k3_err = max_abs_err(v1, sampling.sample_in_ball_stream(stream, p.tau))
        print(f"phase 6: ball_bitplane vs K3 B={b}: max_abs_err {k3_err}; ok rows {int(v1[1].sum())} of {b}")
        if k3_err != 0.0 or bool(v1[1][:4].any()):
            raise AssertionError("K7 differs from K3, or a no-take row is ok")
        rows[-1]["err"] = max(rows[-1]["err"], k3_err)

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    res = bench_kernels.run(N_STATES, N_POLYS, dev)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    missing = [k for k in BENCH_KERNELS + ("sponge", "ball", "ntt") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernel-bench path launched no {missing} kernel")
    ab = {f"{name} {side}": [round(x, 4) for x in ms] for name, sides in res["ab"].items()
          for side, ms in sides.items()}
    print(f"phase 6: bench_kernels {N_STATES} states, {N_POLYS} polys in {time.perf_counter() - t:.1f} s; "
          f"launches {launches}; A/B ms per round {ab}; "
          f"rows {json.dumps({k: round(v['ms'], 4) for k, v in res['rows'].items()})}")
    return rows, launches


def main() -> int:
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
    launches, pk, mus_np, sig_np = main_path(rng, dev)
    bench_rows, bench_launches = check_bench_path(rng, dev, int_ops)
    verify_launches = verify_path(pk, mus_np, sig_np, dev)
    rows += bench_rows
    launches.update({k: bench_launches[k] for k in BENCH_KERNELS})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        primary = next(r for r in mine if r["primary"])
        bound_ms, bound_by = bound(primary["work"], int_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "verify_launches": verify_launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": primary["ms"], "device_ms": primary["device_ms"], "plain_ms": primary["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": primary["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
