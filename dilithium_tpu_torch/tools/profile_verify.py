"""Stage times of the one-key dense-operator verify at service batch.

The port of the root `tools/profile_verify.py`. It signs B random mu under
one key (inputs from `np.random.default_rng(0)` in the root script's
order), then times `mxu.verify_mxu` whole and each of its stages as its
own call (`bench.timeit`: CUDA events over 10 calls on a card; and on a
card the device's own time, `bench_kernels.device_ms`):

  verify_mxu (full)
  unpack_sig, and unpack_hints alone
  sample_in_ball (K1, K3)
  z -> Az (limbs, 3 int8 GEMMs) `mxu._z_times_a`: z's limbs, `mxu._apply_w`
  c -> c.t1<<d (1 int8 GEMM)    `mxu._c_times_t1`, with the limbs' sum mod q
  verify tail                   `scheme._verify_tail`: use_hint, pack_w1,
                                the c_tilde hash; then each alone
  norm_exceeds(z)

    python -m dilithium_tpu_torch.tools.profile_verify [batch]

Dilithium-3, B = 16384 by default. Prints a table on stderr and one JSON
line on stdout (ms a call, a stage: ms, and device_ms on a card). Runs on the card unless
DILITHIUM_BENCH_DEVICE=cpu (the plain versions).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dilithium_tpu_torch import bench, mxu, scheme
from dilithium_tpu_torch.bench_kernels import device_ms
from dilithium_tpu_torch.ops import keccak, pack, rounding, sampling
from dilithium_tpu_torch.ops.reduce import center, sub_mod
from dilithium_tpu_torch.params import N, get_params

LEVEL = 3
ITERS = 10
# calls queued behind the sleep of `device_ms`: a call launches ~200 kernels, and the
# launch queue (~1000 entries) must hold them all, or the host waits for the device
DEVICE_CALLS = 2
CORPUS_WINDOW = 4096  # the root script's window for the corpus; any window gives the same bytes


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if argv else 16384
    p = get_params(LEVEL)
    dev = bench.resolve_device()
    card = bench.describe(dev)
    rng = np.random.default_rng(0)
    bench.log(f"device: {card['device']}, batch: {B}")
    ms, dev_ms = {}, {}

    def t(a):
        return torch.from_numpy(a).to(dev)

    def report(name, fn):
        secs = bench.timeit(fn, dev, ITERS)
        ms[name.strip()] = secs * 1e3
        dev_note = ""
        if dev.type == "cuda":
            dev_ms[name.strip()] = device_ms(fn, n=DEVICE_CALLS)
            dev_note = f", device {dev_ms[name.strip()]:9.3f} ms"
        bench.log(f"{name:28s} {secs * 1e3:9.3f} ms   ({secs / B * 1e6:8.4f} us/sig){dev_note}")
        return fn()

    kp = scheme.keygen(t(rng.integers(0, 256, (1, 32), dtype=np.uint8)), p)
    mu = t(rng.integers(0, 256, (B, 64), dtype=np.uint8))
    res = mxu.sign_stream_mxu(mxu.build_operators(kp.sk[0], p), mu, p, window=CORPUS_WINDOW)
    if not bool(res.ok.all()):
        bench.log("profile_verify: a corpus signature is not ok")
        return 1
    sig = res.sig
    vops = mxu.build_verify_operators(kp.pk[0], p)

    ok = report("verify_mxu (full)", lambda: mxu.verify_mxu(vops, sig, mu, p))
    if not bool(ok.all()):
        bench.log("profile_verify: verify_mxu rejects a corpus signature")
        return 1
    c_tilde, z, h, h_ok = report("unpack_sig", lambda: pack.unpack_sig(sig, p))
    hint_at = 32 + p.L * p.polyz_packedbytes
    report("  unpack_hints only", lambda: pack.unpack_hints(sig[:, hint_at:], p))
    c, _ = report("sample_in_ball (K1, K3)", lambda: sampling.sample_in_ball(c_tilde, p))
    az = report("z -> Az (limbs, 3 int8 GEMMs)", lambda: mxu._z_times_a(vops, center(z), p))
    ct1 = report("c -> c.t1<<d (1 int8 GEMM)", lambda: mxu._c_times_t1(vops, c, p))
    w = sub_mod(az, ct1).reshape(B, p.K, N)
    report("verify tail (usehint+hash)", lambda: scheme._verify_tail(w, h, c_tilde, mu, h_ok, p))
    w1 = report("  use_hint only", lambda: rounding.use_hint(h, w, p))
    w1p = report("  pack_w1 only", lambda: pack.pack_w1(w1, p)).reshape(B, p.K * p.polyw1_packedbytes)
    report("  c_tilde hash only (K1)", lambda: keccak.shake256(torch.cat([mu, w1p], dim=-1), 32))
    report("norm_exceeds(z)", lambda: rounding.norm_exceeds(center(z), p.gamma1 - p.beta, dim=(-2, -1)))
    bench.log_launches()
    print(json.dumps({"batch": B, "level": LEVEL, **card, "ms": {k: round(v, 4) for k, v in ms.items()},
                      "device_ms": {k: round(v, 4) for k, v in dev_ms.items()} or None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
