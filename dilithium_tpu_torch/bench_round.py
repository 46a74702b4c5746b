"""The NTT-form stream signer's round body against its bare attempt: the
loop's overhead, at one window.

The port of the root `bench_round.py`. Dilithium-3, one key from
`np.random.default_rng(0)`, W lanes; each stage is timed over a run of
calls (`bench.timeit`: CUDA events on a card):

  attempt only          `scheme._sign_attempt` on W lanes (the key
                        material broadcast as views);
  attempt + pack_sig    the same and `pack.pack_sig` of its candidates;
  full round            `scheme.sign_stream(max_rounds=1)`: one round with
                        rhoprime, the slot map, the commit and the packing;
  stream                a steady `sign_stream` over Q = W mu, one call
                        after a warm-up call, every signature ok.

    python -m dilithium_tpu_torch.bench_round [window]

Prints a table on stderr and one JSON line on stdout. Runs on the card
unless DILITHIUM_BENCH_DEVICE=cpu (the plain versions, for tests).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from dilithium_tpu_torch import bench, scheme
from dilithium_tpu_torch.ops import pack
from dilithium_tpu_torch.params import get_params

LEVEL = 3


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    W = int(argv[0]) if argv else 768
    dev = bench.resolve_device()
    card = bench.describe(dev)
    p = get_params(LEVEL)
    rng = np.random.default_rng(0)
    bench.log(f"device: {card['device']}, window: {W}")

    def t(a):
        return torch.from_numpy(a).to(dev)

    seed = t(rng.integers(0, 256, (32,), dtype=np.uint8))
    ek = scheme.expand_sk(scheme.keygen(seed, p).sk, p)
    mu = t(rng.integers(0, 256, (W, 64), dtype=np.uint8))
    rp = t(rng.integers(0, 256, (W, 64), dtype=np.uint8))
    kap = torch.zeros(W, dtype=torch.int32, device=dev)
    key = (ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat)

    def attempt():
        return scheme._sign_attempt(*key, mu, rp, kap, p)

    def attempt_pack():
        c_tilde, z, h, accept = attempt()
        return pack.pack_sig(c_tilde, z, h, p), accept

    ms = {}
    ms["attempt"] = bench.timeit(attempt, dev) * 1e3
    bench.log(f"attempt only        : {ms['attempt']:8.3f} ms  ({ms['attempt'] / W * 1e3:6.2f} us/lane)")
    ms["attempt_pack"] = bench.timeit(attempt_pack, dev) * 1e3
    bench.log(f"attempt + pack_sig  : {ms['attempt_pack']:8.3f} ms  "
              f"(+{(ms['attempt_pack'] - ms['attempt']) / W * 1e3:6.2f} us/lane)")
    ms["round"] = bench.timeit(lambda: scheme.sign_stream(ek, mu, p, window=W, max_rounds=1), dev) * 1e3
    bench.log(f"full round (1-round stream): {ms['round']:8.3f} ms  "
              f"(+{(ms['round'] - ms['attempt_pack']) / W * 1e3:6.2f} us/lane vs pack)")

    scheme.sign_stream(ek, mu, p, window=W, max_rounds=8192)
    bench.sync(dev)
    t0 = time.perf_counter()
    res = scheme.sign_stream(ek, mu, p, window=W, max_rounds=8192)
    bench.sync(dev)
    el = time.perf_counter() - t0
    if not bool(res.ok.all()):
        bench.log("bench_round: a steady-stream signature is not ok")
        return 1
    bench.log(f"stream W={W}, Q={W}: {el:.4f}s, {res.rounds} rounds -> {W / el:.0f} signs/sec")
    bench.log_launches()
    print(json.dumps({
        "level": LEVEL, "window": W, **{f"{k}_ms": round(v, 4) for k, v in ms.items()},
        "stream_s": round(el, 4), "stream_rounds": res.rounds, "stream_signs_per_sec": round(W / el, 1),
        **card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
