"""Data-parallel signing over one process per card: each call signs a
global queue of `per_rank` x chips messages, each rank its contiguous
shard through `parallel.sharded_sign_stream(mesh, p, use_mxu=True)` (the
program's default window), which ends in one all-reduce of the global
counters.

This process is rank 0; it spawns the others and waits for them. The
ranks meet in `parallel.initialize` (NCCL on cards, gloo on the CPU)
through a file store in a temporary directory. Every rank derives the
same key from the seed and builds its operators on its own card; its
shard's messages come from its own stream of the seed. Inside the timed
call a rank hashes its shard (`api.compute_mu_many`), copies mu to its
card and signs; then it reads its ok count, the global counters and its
sampled signatures. After each call the ranks agree (one more
all-reduce) whether the window is over and whether tracing begins, so
all make the same calls and trace the same ones.

Parameters: per_rank, message_prefix_hex, message_random_bytes,
distinct_calls, warm_calls, sample_per_call, max_checked (a rank's),
trace_calls.

Reported: the global signatures over the slowest rank's window; each
rank's own time in its calls up to the service's return (its host clock:
the round loop's last sync has passed there, the all-reduce is queued),
for the ranks' imbalance. Checks (limit 0 each, summed over the ranks):
each rank's key against the reference's; calls in which a rank's ok
count or the global counters were short; sampled signatures that differ
from the reference's. Each rank also counts the top-level modules of
`harness.FORBIDDEN` it has loaded once its window has closed; rank 0
raises ImportError (no result) where any rank has one.

Control (`control`): each rank signs with a random rhoprime
(`mxu.sign_stream_mxu`'s own option), which the configuration's
deterministic signing rules out: the sampled signatures differ from the
reference's.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import tempfile
import time

from benchmark import harness
from benchmark.traffic import common

# the per-rank numbers gathered at the end, in this order
FIELDS = ("window_s", "own_s", "attempted", "answered", "failed", "counters_short", "key_bytes_differ",
          "signatures_differ", "checked", "memory_peak_bytes", "busy_s", "traced_s", "forbidden_modules")


def run(ctx):
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        spawn = multiprocessing.get_context("spawn")
        procs = [spawn.Process(target=_rank, args=(ctx, r, init)) for r in range(1, ctx.chips)]
        for pr in procs:
            pr.start()
        try:
            out = _rank(ctx, 0, init)
        finally:
            for pr in procs:
                pr.join(timeout=120)
                if pr.is_alive():
                    pr.terminate()
                    pr.join()
    codes = [pr.exitcode for pr in procs]
    if any(codes):
        raise RuntimeError(f"ranks 1..{ctx.chips - 1} exited with {codes}")
    return out


def _rank(ctx, rank: int, init: str):
    import torch
    import torch.distributed as dist

    from dilithium_tpu_torch import _kernels, api, mxu, parallel
    from dilithium_tpu_torch.params import get_params

    ctx = dataclasses.replace(ctx, rank=rank)
    if ctx.hook:
        ctx.hook(ctx)
    dev = parallel.initialize(coordinator=init, num_processes=ctx.chips, process_id=rank, device=ctx.device)
    try:
        mesh = parallel.make_mesh(dev)
        prm = ctx.params
        n, world = prm["per_rank"], ctx.chips
        p, rp = get_params(ctx.config["level"]), common.ref_params(ctx.config)
        seed, pk, sk = common.program_keys(ctx)
        ops = mxu.build_operators(torch.frombuffer(bytearray(sk), dtype=torch.uint8).to(dev), p)
        svc = parallel.sharded_sign_stream(mesh, p, use_mxu=True)
        tr = sk[64:96]
        pool = common.messages(ctx, prm["distinct_calls"], n, common.MESSAGES, rank)
        sample = common.sample_rows(ctx, n, prm["sample_per_call"], rank)
        sample_t = torch.from_numpy(sample).to(dev)
        kept, short, own = [], [0], [0.0]

        def sign(msgs):
            mu = torch.from_numpy(api.compute_mu_many(tr, msgs)).to(dev)
            return svc(ops, mu)

        def call(i):
            msgs = pool[i % len(pool)]
            t0 = time.perf_counter()
            res = sign(msgs)
            own[0] += time.perf_counter() - t0
            ok, total = torch.stack([res.ok.sum().to(torch.int64), res.total_signed]).tolist()
            sigs = res.sig[sample_t[i % len(sample)]].cpu().numpy()
            if ok != n or total != n * world:
                short[0] += 1
            kept.extend((msgs[r], sigs[j].tobytes()) for j, r in enumerate(sample[i % len(sample)]))
            return ok

        def agree(stop: bool, begin: bool):
            flags = torch.tensor([int(stop), int(not begin)], device=dev)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=mesh.group)
            all_stop, none_begin = flags.tolist()
            return bool(all_stop), not none_begin

        for msgs in common.messages(ctx, prm["warm_calls"], n, common.WARM, rank):
            sign(msgs).sig.cpu()
        agree(False, False)  # every rank set up: the windows start together
        out = common.drive(ctx, call, n, _kernels.SHAPES, agree)
        del ops
        common.release(ctx.device)
        key_differ, _, ref_sk = common.key_check(seed, pk, sk, rp)
        mine = {
            "window_s": out.window_s, "own_s": own[0], "attempted": out.attempted, "answered": out.answered,
            "failed": out.failed, "counters_short": short[0], "key_bytes_differ": key_differ,
            "signatures_differ": common.signature_check(ctx, ref_sk, common.choose(ctx, kept, prm["max_checked"]), rp),
            "checked": min(len(kept), prm["max_checked"]), "memory_peak_bytes": out.memory_peak_bytes,
            "busy_s": out.trace["busy_s"] if out.trace else 0.0,
            "traced_s": out.trace["window_s"] if out.trace else 0.0,
        }
        leaked = harness.forbidden_loaded()
        if leaked:
            harness.log(f"rank {rank}: modules loaded in the run that must not be: {leaked}")
        mine["forbidden_modules"] = len(leaked)
        table = torch.zeros((world, len(FIELDS)), dtype=torch.float64, device=dev)
        table[rank] = torch.tensor([float(mine[f]) for f in FIELDS], dtype=torch.float64)
        dist.all_reduce(table, group=mesh.group)
        ranks = [dict(zip(FIELDS, row)) for row in table.cpu().tolist()]
    finally:
        dist.destroy_process_group()
    if rank:
        return None
    leaked = [r for r, row in enumerate(ranks) if row["forbidden_modules"]]
    if leaked:
        raise ImportError(f"modules of {harness.FORBIDDEN} loaded in rank(s) {leaked}")

    def total(f):
        return int(sum(r[f] for r in ranks))

    out.attempted, out.answered, out.failed = total("attempted"), total("answered"), total("failed")
    out.window_s = max(r["window_s"] for r in ranks)
    out.memory_peak_bytes = max(int(r["memory_peak_bytes"]) for r in ranks)
    out.checks = {f: (total(f), 0) for f in ("key_bytes_differ", "counters_short", "signatures_differ")}
    out.extra.update(rank_own_s=[r["own_s"] for r in ranks], rank_window_s=[r["window_s"] for r in ranks],
                     checked=total("checked"))
    if out.trace is not None:
        out.trace.update(busy_s=sum(r["busy_s"] for r in ranks) / world,
                         window_s=sum(r["traced_s"] for r in ranks) / world)
    harness.log(f"ranks: own seconds {out.extra['rank_own_s']}, windows {out.extra['rank_window_s']}")
    return out


def control(ctx) -> None:
    """The program signs with a fresh random rhoprime."""
    import torch

    from dilithium_tpu_torch import mxu

    stream = mxu.sign_stream_mxu

    def random_rhoprime(ops, mu, p, window=768, max_rounds=8192, rhoprime=None):
        rp = torch.randint(0, 256, mu.shape, dtype=torch.uint8, device=mu.device)
        return stream(ops, mu, p, window, max_rounds, rp)

    mxu.sign_stream_mxu = random_rhoprime
