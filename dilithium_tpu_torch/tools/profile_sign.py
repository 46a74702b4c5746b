"""Stage times of one dense-operator signing attempt at the window.

The port of the root `tools/profile_sign.py`. The stream signer runs
`mxu._sign_attempt_mxu` on W slots a round; this times the attempt whole
and each of its stages as its own call at B = W (`bench.timeit`: CUDA
events over 30 calls back to back on a card, host time included where
the host is the slower; and on a card the device's own time,
`bench_kernels.device_ms`), on one key and inputs from
`np.random.default_rng(0)` in the root script's order:

  attempt body (full)       `mxu._sign_attempt_mxu`
  expand_mask_limbs (K2)    y as 3 int8 limb planes
  y -> w (3 int8 GEMMs)     `mxu._apply_w` with the limb recombine
  decompose, pack_w1
  c_tilde hash (K1)         SHAKE256(mu || w1 packed, 32)
  sample_in_ball (K1, K3)   the ball stream and the walk
  tail                      `mxu._attempt_tail`: c's int8 GEMM (cs1,
                            cs2, ct0), z, the norms and make_hint

    python -m dilithium_tpu_torch.tools.profile_sign [window] [level]

Prints a table on stderr and one JSON line on stdout (us a round, a stage:
us_per_round, and device_us_per_round on a card).
Runs on the card unless DILITHIUM_BENCH_DEVICE=cpu (the plain versions).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dilithium_tpu_torch import bench, mxu, scheme
from dilithium_tpu_torch.bench_kernels import device_ms
from dilithium_tpu_torch.ops import keccak, pack, rounding, sampling
from dilithium_tpu_torch.params import CRHBYTES, N, get_params

ITERS = 30
# calls queued behind the sleep of `device_ms`: a call launches ~200 kernels, and the
# launch queue (~1000 entries) must hold them all, or the host waits for the device
DEVICE_CALLS = 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    W = int(argv[0]) if argv else 768
    level = int(argv[1]) if len(argv) > 1 else 3
    p = get_params(level)
    K, L = p.K, p.L
    dev = bench.resolve_device()
    card = bench.describe(dev)
    rng = np.random.default_rng(0)
    bench.log(f"device: {card['device']}, window: {W}, level: {level}")
    us, device_us = {}, {}

    def t(a):
        return torch.from_numpy(a).to(dev)

    def report(name, fn):
        secs = bench.timeit(fn, dev, ITERS)
        us[name] = secs * 1e6
        dev_note = ""
        if dev.type == "cuda":
            device_us[name] = device_ms(fn, n=DEVICE_CALLS) * 1e3
            dev_note = f", device {device_us[name]:9.1f} us"
        bench.log(f"{name:30s} {secs * 1e6:9.1f} us/round   ({secs / W * 1e9:8.1f} ns/slot){dev_note}")
        return fn()

    kp = scheme.keygen(t(rng.integers(0, 256, (1, 32), dtype=np.uint8)), p)
    ops = mxu.build_operators(kp.sk[0], p)
    mu = t(rng.integers(0, 256, (W, 64), dtype=np.uint8))
    rp = t(rng.integers(0, 256, (W, CRHBYTES), dtype=np.uint8))
    kappa = torch.arange(W, dtype=torch.int32, device=dev) * L

    report("attempt body (full)", lambda: mxu._sign_attempt_mxu(ops, mu, rp, kappa, p))
    limbs = report("expand_mask_limbs (K2)", lambda: sampling.expand_mask_limbs(rp, kappa, p))
    w = report("y -> w (3 int8 GEMMs)", lambda: mxu._apply_w(limbs, ops.wy_cat)).reshape(W, K, N)
    w1, w0 = report("decompose", lambda: rounding.decompose(w, p))
    w1p = report("pack_w1", lambda: pack.pack_w1(w1, p)).reshape(W, K * p.polyw1_packedbytes)
    ct = report("c_tilde hash (K1)", lambda: keccak.shake256(torch.cat([mu, w1p], dim=-1), 32))
    c, _ = report("sample_in_ball (K1, K3)", lambda: sampling.sample_in_ball(ct, p))
    y_cent = mxu._y_centered(limbs, p)
    report("cs1/cs2/ct0+norms+hints", lambda: mxu._attempt_tail(ops.c_cat, c, y_cent, w0, w1, p))
    bench.log_launches()
    print(json.dumps({"window": W, "level": level, **card,
                      "us_per_round": {k: round(v, 2) for k, v in us.items()},
                      "device_us_per_round": {k: round(v, 2) for k, v in device_us.items()} or None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
