"""Kernel micro-bench: each hand-written kernel alone at large batch.

The counterpart of the JAX package's `bench_kernels.py`, with its A/B rigs
(`tools/xof_exp.py`, `tools/ball_exp.py`) folded in:

  - Keccak-f[1600]: the plain version on [B, 25], and K5 on [B, 25] and on
    planes [25, B], B = n_states;
  - SHAKE128 34 B -> 1008 B and SHAKE256 66 B -> 640 B through K1, at
    n_states / 8 messages;
  - the XOF A/B: SHAKE256 66 B -> 160 words over xof_batch messages
    (20480 by default: the JAX package's W = 4096 x L = 5): A is K1 (`keccak.shake_words`),
    B is the plane prologue + K6 (`tools.xof_exp.xof_bm`), and K6 alone;
  - the ball A/B: SampleInBall at level 3 over ball_batch streams (16384 by
    default): K3 against K7 (`tools.ball_exp.sample_in_ball_v1`);
  - forward and inverse NTT through K4, B = n_polys.

Each A/B runs its sides in turns (A, B, A, B, ...) for ROUNDS rounds
after checking that they agree bit for bit. On the card a time is the
median CUDA-event time of one call over `reps` calls after a warm-up; with
--cpu the same calls run the plain versions and are timed on the host
clock. Prints a table to stderr and one JSON line to stdout.

    python -m dilithium_tpu_torch.bench_kernels [n_states] [n_polys]
        [--xof-batch N] [--ball-batch N] [--reps N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from dilithium_tpu_torch.params import Q, SHAKE256_RATE, get_params
from dilithium_tpu_torch.ops import keccak, ntt, sampling
from dilithium_tpu_torch.tools import ball_exp, xof_exp

# W = 4096 x L = 5: the ExpandMask shape of one round of the JAX package on
# the TPU (the port's round is W = 768, 3840 messages). Kept so that K6's
# primary row stays comparable from one run to the next; chip_smoke.py
# phase 6 times K6 at the port's own shapes.
XOF_BATCH = 4096 * 5
BALL_BATCH = 16384
ROUNDS = 3


def time_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """Median time of one call of fn in ms: CUDA events on a card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn in ms, the host's time left out: a
    `torch.cuda._sleep` holds the stream until the host has queued n calls,
    then CUDA events around the n calls, back to back on the device, give
    their time over n; the median of reps such runs. A run in which the
    device reached the calls before the host had queued them all is taken
    again with a longer sleep; fn must not synchronise."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    cycles = int(max(4 * (time.perf_counter() - t), 1e-3) * 2e9)  # ~2 GHz SM clock
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t = time.perf_counter()
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        for _ in range(n):
            fn()
        e2.record()
        queued_ms = (time.perf_counter() - t) * 1e3
        e2.synchronize()
        if e0.elapsed_time(e1) > queued_ms:
            times.append(e1.elapsed_time(e2) / n)
        elif cycles > 2e10:  # 10 s of sleep did not cover the host: fn waits for the device
            raise RuntimeError("device_ms: the host never got ahead of the device")
        else:
            cycles *= 2
    return statistics.median(times)


def device_ms_turns(fns: dict, rounds: int = ROUNDS) -> dict:
    """Device-only ms of one call of each fn (`device_ms`), taken in turns,
    the order reversed every round -> {name: [ms per round]}."""
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order:
            times[name].append(device_ms(fns[name]))
        order.reverse()
    return times


def _same(a, b, what: str) -> None:
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: the two sides differ")


def run(n_states: int, n_polys: int, device: torch.device, xof_batch: int = XOF_BATCH,
        ball_batch: int = BALL_BATCH, reps: int = 10) -> dict:
    """Time every row; return {"rows": {name: {"ms", "ns_per_unit"}},
    "ab": {name: {side: [ms per round]}}}."""
    rng = np.random.default_rng(0)
    rows, ab = {}, {}

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)

    def report(name, ms, units):
        rows[name] = {"ms": ms, "ns_per_unit": ms * 1e6 / units}
        print(f"{name:40s} {ms:10.4f} ms  ({ms * 1e6 / units:9.2f} ns/unit)", file=sys.stderr)

    def interleave(name, sides, units):
        _same(*[fn() for fn in sides.values()], what=name)
        ab[name] = {side: [] for side in sides}
        for _ in range(ROUNDS):
            for side, fn in sides.items():
                ab[name][side].append(time_ms(fn, device, reps))
        for side, ms in ab[name].items():
            report(f"{name} {side}", statistics.median(ms), units)

    st = torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, (n_states, 25), dtype=np.int64)).to(device)
    planes = st.t().contiguous()
    report("keccak_f1600 plain [B, 25]", time_ms(lambda: keccak.keccak_f1600_plain(st), device, reps), n_states)
    report("keccak_f1600 K5 [B, 25]", time_ms(lambda: keccak.keccak_f1600(st), device, reps), n_states)
    report("keccak_f1600 K5 planes [25, B]",
           time_ms(lambda: keccak.keccak_f1600_planes(planes), device, reps), n_states)

    n_msgs = max(n_states // 8, 1)
    m34, m66 = u8(n_msgs, 34), u8(n_msgs, 66)
    report("shake128 34B->1008B K1", time_ms(lambda: keccak.shake128(m34, 6 * 168), device, reps), n_msgs)
    report("shake256 66B->640B K1", time_ms(lambda: keccak.shake256(m66, 640), device, reps), n_msgs)

    msgs = u8(xof_batch, 66)
    xof_planes = xof_exp.planes_for(msgs, SHAKE256_RATE)
    interleave("xof 66B->160w", {
        "A K1": lambda: (keccak.shake_words(msgs, 160, SHAKE256_RATE),),
        "B planes+K6": lambda: (xof_exp.xof_bm(msgs, 160, SHAKE256_RATE),),
    }, xof_batch)
    report("xof 66B->160w K6 alone", time_ms(
        lambda: xof_exp.shake_words_batchmajor(xof_planes, 160, SHAKE256_RATE // 8), device, reps), xof_batch)

    p = get_params(3)
    stream = keccak.shake256(u8(ball_batch, 32), p.ball_blocks * SHAKE256_RATE)
    interleave("ball level 3", {
        "V0 K3": lambda: sampling.sample_in_ball_stream(stream, p.tau),
        "V1 K7": lambda: ball_exp.sample_in_ball_v1(stream, p.tau),
    }, ball_batch)

    x = torch.from_numpy(rng.integers(0, Q, (n_polys, 256)).astype(np.int32)).to(device)
    report("ntt fwd K4", time_ms(lambda: ntt.ntt(x), device, reps), n_polys)
    report("invntt K4", time_ms(lambda: ntt.invntt(x), device, reps), n_polys)
    return {"rows": rows, "ab": ab}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_states", nargs="?", type=int, default=131072)
    ap.add_argument("n_polys", nargs="?", type=int, default=65536)
    ap.add_argument("--xof-batch", type=int, default=XOF_BATCH)
    ap.add_argument("--ball-batch", type=int, default=BALL_BATCH)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        device, name = torch.device("cpu"), "cpu"
    elif torch.cuda.is_available():
        device, name = torch.device("cuda", 0), torch.cuda.get_device_name(0)
    else:
        print("bench_kernels: no CUDA device (pass --cpu for the plain versions)", file=sys.stderr)
        return 1
    print(f"device: {name}; {args.n_states} keccak states, {args.n_polys} ntt polys, "
          f"xof batch {args.xof_batch}, ball batch {args.ball_batch}", file=sys.stderr)
    res = run(args.n_states, args.n_polys, device, args.xof_batch, args.ball_batch, args.reps)
    route = "plain versions on the CPU" if args.cpu else "CUDA kernels"
    print(json.dumps({"device": name, "route": route, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
