"""Weak-scaling efficiency of one-key signing over N cards.

The port of the root `bench_scaling.py`, on the port's layout: one
process (rank) per card, `torch.distributed` (NCCL between cards, gloo on
the CPU). Every rank derives the same key and queues from
`np.random.default_rng(0)` in the root script's order, then

  (a) times `mxu.sign_stream_mxu` alone on its card over per_dev mu
      (all ranks at once, each on its own card);
  (b) times `parallel.sharded_sign_stream(mesh, p, window, use_mxu=True)`
      over N * per_dev global mu, each rank signing its contiguous shard;

each `iters` calls after a warm-up call, on the host clock to a
synchronize. Rank 0 prints ONE JSON line: efficiency = (global rate / N)
/ the mean single-card rate, where the global rate is the global queue
over the slowest rank's time. Every signature must be ok and the global
counters must equal the global queue, or the script exits 1.

    python -m dilithium_tpu_torch.bench_scaling
    torchrun --nproc-per-node=N -m dilithium_tpu_torch.bench_scaling
    python -m dilithium_tpu_torch.bench_scaling --coordinator=host0:29500 \\
        --num-processes=N --process-id=$i [--device cuda|cpu]

With no coordinator (and no torchrun environment) it runs a world of one
rank, N = 1, as the root script does on one chip. --device (default
DILITHIUM_BENCH_DEVICE, else cuda) cpu runs gloo and the plain versions;
its line names the CPU. Environment: DILITHIUM_BENCH_LEVEL [3],
DILITHIUM_BENCH_BATCH [16384] (per_dev), DILITHIUM_BENCH_ITERS [10],
DILITHIUM_BENCH_WINDOW [the level's `scheme.default_window`].
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dilithium_tpu_torch import bench, mxu, scheme
from dilithium_tpu_torch.parallel import initialize, local_batch_to_global, make_mesh, sharded_sign_stream
from dilithium_tpu_torch.params import get_params

MAX_ROUNDS = 8192
TARGET = 0.95  # BASELINE.md's north star: 95% of linear


def measure(mesh, level: int, per_dev: int, iters: int, window: int | None) -> dict:
    """Steps (a) and (b) of the module docstring on this rank -> the
    line's numbers (the same on every rank)."""
    dev, rank, n = mesh.device, mesh.rank, mesh.world_size
    p = get_params(level)
    rng = np.random.default_rng(0)
    kp = scheme.keygen(torch.from_numpy(rng.integers(0, 256, size=(32,), dtype=np.uint8)).to(dev), p)
    ops = mxu.build_operators(kp.sk, p)
    mu1 = torch.from_numpy(rng.integers(0, 256, size=(per_dev, 64), dtype=np.uint8)).to(dev)
    mu_n = rng.integers(0, 256, size=(per_dev * n, 64), dtype=np.uint8)
    local = local_batch_to_global(mesh, mu_n[rank * per_dev:(rank + 1) * per_dev])

    def timed(run, mu):
        run(mu)
        bench.sync(dev)
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run(mu)
        bench.sync(dev)
        return time.perf_counter() - t0, out

    dt1, res = timed(lambda m: mxu.sign_stream_mxu(ops, m, p, window=window, max_rounds=MAX_ROUNDS), mu1)
    single_ok = bool(res.ok.all())
    svc = sharded_sign_stream(mesh, p, window=window, max_rounds=MAX_ROUNDS, use_mxu=True)
    dtn, sres = timed(lambda m: svc(ops, m), local)
    # per rank: its single rate, its mesh time, and its failures
    stats = torch.zeros((3, n), dtype=torch.float64, device=dev)
    stats[0, rank] = per_dev * iters / dt1
    stats[1, rank] = dtn
    stats[2, rank] = (not single_ok) + (not bool(sres.ok.all()))
    dist.all_reduce(stats, group=mesh.group)
    single = stats[0].cpu().tolist()
    global_rate = per_dev * n * iters / float(stats[1].max())
    return {"single": single, "global": global_rate, "failures": int(stats[2].sum()),
            "signed": int(sres.total_signed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dilithium_tpu_torch.bench_scaling", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's address host:port, or an init URL (default: torchrun's, else a world of one)")
    ap.add_argument("--num-processes", type=int, default=None, help="world size (default: WORLD_SIZE)")
    ap.add_argument("--process-id", type=int, default=None, help="this process's rank (default: RANK)")
    ap.add_argument("--device", default=os.environ.get("DILITHIUM_BENCH_DEVICE", "cuda"), choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    env = os.environ
    level = int(env.get("DILITHIUM_BENCH_LEVEL", "3"))
    per_dev = int(env.get("DILITHIUM_BENCH_BATCH", "16384"))
    iters = int(env.get("DILITHIUM_BENCH_ITERS", "10"))
    window = int(env["DILITHIUM_BENCH_WINDOW"]) if "DILITHIUM_BENCH_WINDOW" in env else None
    head = {"metric": f"dilithium{level}_sign_scaling_efficiency"}

    with tempfile.TemporaryDirectory() as tmp:
        coordinator, nproc, pid = args.coordinator, args.num_processes, args.process_id
        if coordinator is None and "MASTER_ADDR" not in env:
            coordinator, nproc, pid = f"file://{os.path.join(tmp, 'store')}", 1, 0
        try:
            dev = initialize(coordinator=coordinator, num_processes=nproc, process_id=pid, device=args.device)
        except RuntimeError as e:
            bench.log(f"bench_scaling: {e}")
            print(json.dumps({**head, "value": None, "error": "device_unavailable", "detail": str(e)[:200]}))
            return 1
        try:
            mesh = make_mesh(dev)
            n = mesh.world_size
            card = bench.describe(dev)
            bench.log(f"rank {mesh.rank}/{n}: {card['device']} ({dev}), backend {dist.get_backend()}")
            r = measure(mesh, level, per_dev, iters, window)
        finally:
            dist.destroy_process_group()
    single = sum(r["single"]) / n
    eff = (r["global"] / n) / single
    bench.log(f"rank {mesh.rank}: single-card {r['single']} signs/sec, {n}-card mesh {r['global']:.1f} signs/sec")
    bench.log_launches()
    if r["failures"] or r["signed"] != per_dev * n:
        bench.log(f"bench_scaling: {r['failures']} failed runs, {r['signed']} of {per_dev * n} signed")
        return 1
    if mesh.rank == 0:
        print(json.dumps({
            **head, "value": round(eff, 4), "unit": f"fraction_of_linear_x{n}",
            "vs_baseline": round(eff / TARGET, 3), "n": n, "per_dev": per_dev, "iters": iters,
            "single_signs_per_sec": round(single, 1), "single_by_rank": [round(x, 1) for x in r["single"]],
            "global_signs_per_sec": round(r["global"], 1), **card,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
