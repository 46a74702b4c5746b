#!/usr/bin/env python3
"""Drive the PyTorch port's one-key Dilithium signing path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the last
line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of dilithium_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, bit-equal,
     at the shapes the Dilithium-3 main path gives it, with the median
     CUDA-event time of each;
  4. a small slice (Dilithium-2, Q = 64, W = 32) on the card against the
     port's plain path on the CPU: equal keys, operators and signatures;
  5. the main path: Dilithium-3, one key from a fixed seed, keygen ->
     build_operators -> MxuSigner over Q = 16384 mu at W = 768; every
     kernel must have launched, every signature must be ok and verify under
     the C++ oracle, and 512 must equal the oracle's signatures and
     attempts. Prints signs/s over timed runs after a warm-up run.
Then one JSON line with the kernels' launch counts, errors and times, the
card line again, and last {"ok": true, "device": {...}}.

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

KERNELS = {
    "sponge": ("dilithium_tpu_torch/csrc/sponge.cu", "dilithium_tpu/ops/keccak_pallas.py:217"),
    "mask_limbs": ("dilithium_tpu_torch/csrc/mask_limbs.cu", "dilithium_tpu/ops/keccak_pallas.py:172"),
    "ball": ("dilithium_tpu_torch/csrc/ball.cu", "dilithium_tpu/ops/ball_pallas.py:80"),
    "ntt": ("dilithium_tpu_torch/csrc/ntt.cu", "dilithium_tpu/ops/ntt_pallas.py:177"),
}


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


def check_kernels(rng, dev):
    """Phase 3: kernel vs plain version at the main path's shapes."""
    from dilithium_tpu_torch.params import get_params
    from dilithium_tpu_torch.ops import keccak, ntt, sampling

    p = get_params(3)
    rows = []

    def compare(kernel, label, fn, plain_fn, primary=False):
        got, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        ms, plain_ms = time_ms(fn), time_ms(plain_fn)
        print(f"phase 3: {kernel} {label}: max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if err != 0.0:
            raise AssertionError(f"{kernel} {label} differs from its plain version")
        rows.append((kernel, label, err, ms, plain_ms, primary))

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    sponge_shapes = [  # label, batch, msg_len, out_bytes, rate
        ("seedbuf", 1, 32, 128, 136),
        ("expand_a", p.K * p.L, 34, 840, 168),
        ("expand_s", p.K + p.L, 66, p.eta_blocks * 136, 136),
        ("tr", 1, p.pk_bytes, 32, 136),
        ("rhoprime", Q_MAIN, 96, 64, 136),
        ("c_tilde", W_MAIN, 64 + p.K * p.polyw1_packedbytes, 32, 136),
        ("ball_stream", W_MAIN, 32, 272, 136),
    ]
    for label, b, n, out, rate in sponge_shapes:
        msg = u8(b, n)
        compare("sponge", f"{label} [{b}, {n}] -> {out}",
                lambda: keccak.sponge(msg, out, rate, 0x1F),
                lambda: keccak.sponge_plain(msg, out, rate, 0x1F),
                primary=label == "c_tilde")

    rp = u8(W_MAIN, 64)
    kappa = torch.from_numpy(rng.integers(0, 400, W_MAIN).astype(np.int32) * p.L).to(dev)
    compare("mask_limbs", f"W={W_MAIN}",
            lambda: sampling.expand_mask_limbs(rp, kappa, p),
            lambda: sampling.mask_limbs_plain(rp, kappa, p), primary=True)

    stream = keccak.sponge_plain(u8(W_MAIN, 32), 272, 136, 0x1F)
    stream[:4, 8:] = 255  # no candidate taken: ok = 0, the j = 0 fill path

    compare("ball", f"B={W_MAIN}", lambda: sampling.sample_in_ball_stream(stream, p.tau),
            lambda: sampling.sample_in_ball_plain(stream, p.tau), primary=True)

    def coeffs(b):
        return torch.from_numpy(rng.integers(0, 8380417, (b, 256)).astype(np.int32)).to(dev)

    for label, x, fn, plain_fn, primary in [
        ("forward [5, 256]", coeffs(5), ntt.ntt, ntt.ntt_plain, False),
        ("inverse plain [30, 256]", coeffs(30), lambda v: ntt.invntt(v, False),
         lambda v: ntt.invntt_plain(v, False), True),
        ("inverse product [6, 256]", coeffs(6), ntt.invntt, ntt.invntt_plain, False),
        ("forward [4096, 256]", coeffs(4096), ntt.ntt, ntt.ntt_plain, False),
        ("inverse product [4096, 256]", coeffs(4096), ntt.invntt, ntt.invntt_plain, False),
    ]:
        compare("ntt", label, lambda: fn(x), lambda: plain_fn(x), primary)
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


def main_path(rng, dev):
    """Phase 5: the main path at full size, counted, checked and timed."""
    from dilithium_tpu import oracle
    from dilithium_tpu_torch import _kernels, mxu, scheme
    from dilithium_tpu_torch.params import get_params

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
    missing = [k for k, v in launches.items() if v == 0]
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
    return launches


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
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"phase 2: built {lib} in {time.perf_counter() - t:.1f} s; ptxas: {' | '.join(ptxas)}")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    rows = check_kernels(rng, dev)
    check_small_slice(rng, dev)
    launches = main_path(rng, dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r[0] == name]
        primary = next(r for r in mine if r[5])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r[2] for r in mine),
            "ms": primary[3], "plain_ms": primary[4], "shape": primary[1],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
