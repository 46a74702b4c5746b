"""Per-subsystem times at batch B, and wall latencies at B = 1 and 64:
where does sign time go?

The port of the root `bench_components.py`, row for row under the same
names, Dilithium-3, inputs from `np.random.default_rng(0)` in its order.
Each throughput row is the port's counterpart of the JAX function, timed
over a run of calls (`bench.timeit`: CUDA events on a card) after a
warm-up call:

  keccak_f1600 x30B        `ops.keccak.keccak_f1600` on [30 B, 25] (K5)
  shake128 expandA-shape   SHAKE128 of B K L 34-byte messages (K1)
  ntt fwd xBL, invntt xBL  `ops.ntt` on [B L, 256] (K4)
  matvec                   `ntt.matvec` [B, K, L, 256] x [B, L, 256]
  expand_mask              `sampling.expand_mask` on B lanes (K1)
  sample_in_ball           `sampling.sample_in_ball` on B lanes (K1, K3)
  expand_a                 ExpandA of min(B, 2048) keys (K1)
  decompose, pack_z        on [B, K, 256] and [B, L, 256]
  sign_attempt             `scheme._sign_attempt`, one key on B lanes
  sign_attempt_mxu         `mxu._sign_attempt_mxu` (K2, K1, K3, int8 GEMMs)
  keygen                   min(B, 2048) keys
  verify_expanded, verify_mxu   one key, B signatures
  verify_fresh_keys        `scheme.verify`, a key a lane (ExpandA a lane)

Then, unless DILITHIUM_BENCH_LATENCY=0, the wall latency of keygen, the
lockstep sign and verify_expanded at B = 1 and B = 64: the median over
`--latency-calls` calls (21) of one call ending in a synchronize.

    python -m dilithium_tpu_torch.bench_components [batch] [--latency-calls N]

Prints a table on stderr and one JSON line on stdout: per_unit_us (the
root script's line: microseconds a unit of each row; a latency row's unit
is the call) and ms (a call). Runs on the card unless
DILITHIUM_BENCH_DEVICE=cpu (the plain versions, for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from dilithium_tpu_torch import bench, mxu, scheme
from dilithium_tpu_torch.ops import keccak, ntt, pack, rounding, sampling
from dilithium_tpu_torch.params import Q, get_params

LEVEL = 3
EXPAND_A_CAP = 2048  # expand_a, keygen and verify_fresh_keys run on min(B, this) keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dilithium_tpu_torch.bench_components",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("--latency-calls", type=int, default=21, help="timed calls a latency row")
    args = ap.parse_args(argv)
    B = args.batch
    dev = bench.resolve_device()
    card = bench.describe(dev)
    p = get_params(LEVEL)
    rng = np.random.default_rng(0)
    bench.log(f"device: {card['device']}, batch: {B}")
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def u8(*shape):
        return t(rng.integers(0, 256, shape, dtype=np.uint8))

    def mod_q(*shape):
        return t(rng.integers(0, Q, shape, dtype=np.int64).astype(np.int32))

    def report(name, secs, units=1):
        rows[name] = {"ms": secs * 1e3, "per_unit_us": secs / units * 1e6}
        bench.log(f"{name:26s} {secs * 1e3:9.3f} ms   ({secs / units * 1e6:8.3f} us/unit)")

    # 30 B states: the root script's [.., 25, 2] uint32 draws as int64 lanes
    halves = rng.integers(0, 1 << 32, (B * 30, 25, 2), dtype=np.uint64)
    st = t((halves[..., 0] | (halves[..., 1] << np.uint64(32))).view(np.int64))
    report("keccak_f1600 x30B", bench.timeit(lambda: keccak.keccak_f1600(st), dev), B * 30)

    msgs = u8(B * p.K * p.L, 34)
    nbytes_a = p.uniform_blocks * 168
    report("shake128 expandA-shape", bench.timeit(lambda: keccak.shake128(msgs, nbytes_a), dev, 3),
           B * p.K * p.L)

    x = mod_q(B * p.L, 256)
    report("ntt fwd xBL", bench.timeit(lambda: ntt.ntt(x), dev), B * p.L)
    report("invntt xBL", bench.timeit(lambda: ntt.invntt(x, from_product=True), dev), B * p.L)

    a = mod_q(B, p.K, p.L, 256)
    s = mod_q(B, p.L, 256)
    report("matvec", bench.timeit(lambda: ntt.matvec(a, s), dev), B)

    rp = u8(B, 64)
    kap = torch.zeros(B, dtype=torch.int32, device=dev)
    report("expand_mask", bench.timeit(lambda: sampling.expand_mask(rp, kap, p), dev), B)

    ct = u8(B, 32)
    report("sample_in_ball", bench.timeit(lambda: sampling.sample_in_ball(ct, p), dev), B)

    Ba = min(B, EXPAND_A_CAP)
    rho = u8(Ba, 32)
    report("expand_a", bench.timeit(lambda: sampling.expand_a(rho, p), dev, 3), Ba)

    w = mod_q(B, p.K, 256)
    report("decompose", bench.timeit(lambda: rounding.decompose(w, p), dev), B)

    z = mod_q(B, p.L, 256)
    report("pack_z", bench.timeit(lambda: pack.pack_z(z, p), dev), B)

    # one key on B lanes: the attempt's cost does not depend on the key count
    seed = u8(Ba, 32)
    kp = scheme.keygen(seed[:1], p)
    ek = scheme.expand_sk(kp.sk[0], p)
    mu = u8(B, 64)
    report("sign_attempt", bench.timeit(
        lambda: scheme._sign_attempt(ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat, mu, rp, kap, p), dev), B)
    ops = mxu.build_operators(kp.sk[0], p)
    report("sign_attempt_mxu", bench.timeit(lambda: mxu._sign_attempt_mxu(ops, mu, rp, kap, p), dev), B)
    report("keygen", bench.timeit(lambda: scheme.keygen(seed, p).sk, dev, 3), Ba)

    # one key, B copies of one signature: the service shape
    res = scheme.sign(kp.sk, mu[:1], p)
    sig_b = res.sig[0].expand(B, p.sig_bytes)
    epk = scheme.expand_pk(kp.pk[0], p)
    report("verify_expanded", bench.timeit(lambda: scheme.verify_expanded(epk, sig_b, mu, p), dev), B)
    vops = mxu.build_verify_operators(kp.pk[0], p)
    report("verify_mxu", bench.timeit(lambda: mxu.verify_mxu(vops, sig_b, mu, p), dev), B)
    # a key a lane (ExpandA a lane); the signatures do not match the keys,
    # which runs the same work to ok = False
    pk_many = scheme.keygen(seed, p).pk
    report("verify_fresh_keys", bench.timeit(
        lambda: scheme.verify(pk_many, sig_b[:Ba], mu[:Ba], p), dev, 3), Ba)

    if os.environ.get("DILITHIUM_BENCH_LATENCY", "1") != "0":
        n = args.latency_calls

        def lat(fn):
            fn()
            bench.sync(dev)
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                bench.sync(dev)
                ts.append(time.perf_counter() - t0)
            return statistics.median(ts)

        def report_lat(name, secs):
            rows[name] = {"ms": secs * 1e3, "per_unit_us": secs * 1e6}
            bench.log(f"{name:26s} {secs * 1e3:9.3f} ms   (wall latency, median of {n})")

        for Bl in (1, 64):
            seed_l = u8(Bl, 32)
            mu_l = u8(Bl, 64)
            sk_l = kp.sk.expand(Bl, p.sk_bytes)
            sig_l = res.sig[0].expand(Bl, p.sig_bytes)
            report_lat(f"latency keygen B={Bl}", lat(lambda: scheme.keygen(seed_l, p).sk))
            report_lat(f"latency sign B={Bl}", lat(lambda: scheme.sign(sk_l, mu_l, p).sig))
            report_lat(f"latency verify B={Bl}", lat(lambda: scheme.verify_expanded(epk, sig_l, mu_l, p)))

    bench.log_launches()
    print(json.dumps({
        "batch": B, "level": LEVEL, **card,
        "per_unit_us": {k: round(v["per_unit_us"], 3) for k, v in rows.items()},
        "ms": {k: round(v["ms"], 4) for k, v in rows.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
