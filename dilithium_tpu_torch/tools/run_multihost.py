"""Multi-process data-parallel signing launcher.

The port of `tools/run_multihost.py`, on `torch.distributed`: every
process (one per card) runs this module, `parallel.initialize` joins the
process group (NCCL between cards, gloo between CPU processes), each
process derives the same keys and global message queue from --seed,
signs only its contiguous shard, and the global all-reduced counters come
back identical in every process.

One process per card on each host, by hand:

  python -m dilithium_tpu_torch.tools.run_multihost \\
      --coordinator=host0:29500 --num-processes=4 --process-id=$i \\
      [--level 3] [--global-batch 16384] [--window W] \\
      [--signer mxu|stream|lockstep|keys] [--verify] [--out shard_sigs.npy]

or through torchrun, which supplies the process group's address, size
and ranks (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK):

  torchrun --nproc-per-node=4 -m dilithium_tpu_torch.tools.run_multihost ...

--device cpu runs the plain versions on the CPU over gloo (the tests'
two-process run); --device cuda (the default) runs on cuda:LOCAL_RANK
(cuda:process-id modulo the cards without torchrun) over NCCL, and raises
where there is no card.

The keys, the queue and key_idx come from --seed in the JAX launcher's
order and numpy calls, so the same flags give the same shard bytes.

Prints one JSON line on stdout per process:
  {"process_id": i, "signed": <global sum>, "attempts": <global sum>,
   "local_batch": n, "elapsed_s": t, "signs_per_sec": r, ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dilithium_tpu_torch.tools.run_multihost", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's address host:port, or an init URL (default: torchrun's MASTER_ADDR/PORT)")
    ap.add_argument("--num-processes", type=int, default=None, help="world size (default: WORLD_SIZE)")
    ap.add_argument("--process-id", type=int, default=None, help="this process's rank (default: RANK)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card per process (default); cpu: gloo and the plain versions")
    ap.add_argument("--level", type=int, default=3, choices=(2, 3, 5))
    ap.add_argument("--global-batch", type=int, default=16384,
                    help="total message queue size across all processes")
    ap.add_argument("--window", type=int, default=None,
                    help="attempt slots a round (default: the level's scheme.default_window)")
    ap.add_argument("--max-rounds", type=int, default=8192)
    ap.add_argument("--signer", default="mxu", choices=("mxu", "stream", "lockstep", "keys"),
                    help="mxu: dense-operator elastic signer; stream: generic-NTT elastic signer; "
                         "lockstep: scheme.sign; keys: independent-keys elastic signer "
                         "(sharded_sign_stream_keys, --nkeys distinct keys)")
    ap.add_argument("--nkeys", type=int, default=4, help="distinct keys for --signer=keys")
    ap.add_argument("--verify", action="store_true",
                    help="after signing, verify the signatures with the sharded verify service "
                         "(per-row keys for --signer=keys, else the one-key sharded_verify_stream) "
                         "and report the global verified count")
    ap.add_argument("--seed", type=int, default=0,
                    help="deterministic key + message seed (same in every process)")
    ap.add_argument("--out", default=None, help="write this process's local signature shard (npy)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from dilithium_tpu_torch import mxu, scheme
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.parallel import (
        initialize, local_batch_to_global, make_mesh, sharded_sign, sharded_sign_stream,
        sharded_sign_stream_keys, sharded_verify, sharded_verify_stream, throughput_counters,
    )

    dev = initialize(coordinator=args.coordinator, num_processes=args.num_processes,
                     process_id=args.process_id, device=args.device)
    try:
        mesh = make_mesh(dev)
        pid, nproc = mesh.rank, mesh.world_size
        p = get_params(args.level)

        def log(*a):
            print(f"[process {pid}/{nproc}]", *a, file=sys.stderr, flush=True)

        log(f"device {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}), "
            f"backend {dist.get_backend()}")

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        # Keys from --seed, the same in every process: one key for the
        # one-key signers, --nkeys for the keys service. The keys service
        # always runs keygen on the batched seeds [nkeys, 32], so its key
        # axis exists for --nkeys 1 too.
        rng = np.random.default_rng(args.seed)
        n_keys = args.nkeys if args.signer == "keys" else 1
        seed = rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8)
        kp = scheme.keygen(t(seed if args.signer == "keys" else seed[0]), p)

        # The global queue from the same rng in every process; each keeps
        # its contiguous shard. The batch must divide over the processes.
        B = args.global_batch - args.global_batch % nproc
        mu_global = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
        per = B // nproc
        rows = slice(pid * per, (pid + 1) * per)
        mu = local_batch_to_global(mesh, mu_global[rows])

        t0 = time.time()
        if args.signer == "lockstep":
            res = sharded_sign(mesh, p, replicate_key=True)(kp.sk, mu)
        elif args.signer == "keys":
            key_idx_global = rng.integers(0, n_keys, size=(B,)).astype(np.int32)
            key_idx = local_batch_to_global(mesh, key_idx_global[rows])
            eks = scheme.expand_sk(kp.sk, p)
            res = sharded_sign_stream_keys(mesh, p, window=args.window, max_rounds=args.max_rounds)(
                eks, key_idx, mu)
        else:
            use_mxu = args.signer == "mxu"
            km = mxu.build_operators(kp.sk, p) if use_mxu else scheme.expand_sk(kp.sk, p)
            res = sharded_sign_stream(mesh, p, window=args.window, max_rounds=args.max_rounds,
                                      use_mxu=use_mxu)(km, mu)
        counters = throughput_counters(res)
        elapsed = time.time() - t0
        log(f"signed {counters['signed']}/{B} globally, mean attempts {counters['mean_attempts']:.2f}, "
            f"{elapsed:.3f} s (first call: key expansion and set-up included)")

        verified = None
        if args.verify:
            if args.signer == "keys":
                _, total_v = sharded_verify(mesh, p)(kp.pk[key_idx.to(torch.int64)], res.sig, mu)
            else:
                vops = mxu.build_verify_operators(kp.pk, p)
                _, total_v = sharded_verify_stream(mesh, p)(vops, res.sig, mu)
            verified = int(total_v)
            log(f"verified {verified}/{B} globally")

        local_sig = res.sig.cpu().numpy()
        if args.out:
            np.save(args.out, local_sig)
            log(f"local shard {local_sig.shape} -> {args.out}")

        print(json.dumps({
            "process_id": pid,
            "num_processes": nproc,
            "signed": counters["signed"],
            "attempts": counters["attempts"],
            "verified": verified,
            "local_batch": per,
            "global_batch": B,
            "elapsed_s": round(elapsed, 4),
            "signs_per_sec": round(B / elapsed, 1),
        }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
