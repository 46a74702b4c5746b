"""What the traffic kinds share: the key from the seed, message pools,
the closed loop of one process, and the reference's checks."""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import harness
from benchmark.reference import dilithium as ref

# generator tags: one independent stream of the seed per purpose
KEY, MESSAGES, WARM, SAMPLE, CHECK, CORRUPT = range(6)
SAMPLE_TABLE = 4096  # call indices with their own sampled rows (then they repeat)


def ref_params(config: dict) -> ref.Params:
    """The reference's parameter set from the configuration file."""
    return ref.Params(*(config[k] for k in ("level", "K", "L", "eta", "tau", "gamma1", "gamma2", "omega")))


def program_keys(ctx: harness.Context):
    """(seed bytes, pk, sk): the key pair the program derives from 32
    seed bytes drawn from the run's seed."""
    from dilithium_tpu_torch import api

    seed = harness.rng(ctx.seed, KEY).bytes(32)
    pks, sks = api.keygen(ctx.config["level"], [seed], device=ctx.device)
    return seed, pks[0], sks[0]


def bytes_differ(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    return int((np.frombuffer(a[:n], np.uint8) != np.frombuffer(b[:n], np.uint8)).sum()) + abs(len(a) - len(b))


def key_check(seed: bytes, pk: bytes, sk: bytes, p: ref.Params):
    """-> (bytes of the program's pk and sk that differ from the
    reference's key generation on the same seed, the reference's pk, its
    sk). The reference goes on with its own key, not the program's."""
    rpk, rsk = ref.keygen(seed, p)
    return bytes_differ(pk, rpk) + bytes_differ(sk, rsk), rpk, rsk


def messages(ctx: harness.Context, calls: int, batch: int, tag: int = MESSAGES, *stream) -> list:
    """calls lists of batch messages: the mix's prefix (hex) and then
    `message_random_bytes` bytes drawn from the seed."""
    prefix = bytes.fromhex(ctx.params.get("message_prefix_hex", ""))
    n = ctx.params["message_random_bytes"]
    blob = harness.rng(ctx.seed, tag, *stream).bytes(calls * batch * n)
    return [[prefix + blob[(c * batch + i) * n:(c * batch + i + 1) * n] for i in range(batch)]
            for c in range(calls)]


def sample_rows(ctx: harness.Context, batch: int, per_call: int, *stream) -> np.ndarray:
    """int [SAMPLE_TABLE, k]: the rows each call index keeps for the
    reference, drawn from the seed (k = min(per_call, batch))."""
    g = harness.rng(ctx.seed, SAMPLE, *stream)
    k = min(per_call, batch)
    return np.stack([g.choice(batch, k, replace=False) for _ in range(SAMPLE_TABLE)])


def choose(ctx: harness.Context, items: list, k: int) -> list:
    """Up to k of items, drawn from the seed."""
    if len(items) <= k:
        return items
    idx = harness.rng(ctx.seed, CHECK).choice(len(items), k, replace=False)
    return [items[i] for i in sorted(idx)]


def signature_check(ctx: harness.Context, ref_sk: bytes, kept: list, p: ref.Params) -> int:
    """kept: (message, the program's signature) pairs. -> how many differ
    from the reference's deterministic signature of the message under the
    reference's own sk (computed once a distinct message)."""
    rsk = ref.unpack_sk(ref_sk, p)
    msgs = sorted({m for m, _ in kept})
    want = dict(zip(msgs, ref.sign(rsk, [ref.compute_mu(rsk.tr, m) for m in msgs], p)))
    return sum(sig != want[m] for m, sig in kept)


def peak_memory(device: str) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def release(device: str) -> None:
    """Free the card's cached blocks before the reference runs."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def drive(ctx: harness.Context, call, per_call: int, counter=None, agree=None) -> harness.Outcome:
    """The closed loop of one process over call(i) -> answers, into an
    Outcome: its window, latencies, attempted and failed answers, trace
    and peak memory. The objects made in set-up (the input pools: up to
    millions of tuples) are frozen out of the garbage collector's reach
    for the window, so the program's collections do not walk them."""
    gc.collect()
    gc.freeze()
    try:
        times, answered, error, summary = harness.closed_loop(ctx, call, counter, ctx.params.get("trace_calls", 0),
                                                              agree)
    finally:
        gc.unfreeze()
    calls = len(times) + (error is not None)
    out = harness.Outcome(attempted=calls * per_call, answered=answered, trace=summary)
    out.failed = out.attempted - answered
    out.window_start = times[0][0] if times else time.perf_counter()
    out.window_s = times[-1][1] - times[0][0] if times else 0.0
    out.latencies_s = [t1 - t0 for t0, t1 in times]
    if times:
        lat = np.asarray(out.latencies_s)
        harness.log(f"window: {len(times)} calls in {out.window_s} s; a call min {lat.min()} s, median "
                    f"{float(np.median(lat))} s, max {lat.max()} s; {answered} answers")
    out.memory_peak_bytes = peak_memory(ctx.device)
    out.device_kind = harness.card(ctx.device)[0]
    return out
