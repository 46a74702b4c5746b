"""Device time per round of the one-key signing path, by kernel group.

    python -m dilithium_tpu_torch.tools.round_profile

Signs a Dilithium-3 queue of 16384 random mu under one key, both made
from a fixed seed (`MxuSigner`, 768 attempt slots), twice to warm up,
then once more under torch.profiler with CUDA activity only. It prints
one line: device time per round of K1 (sponge), K2 (mask limbs), K3
(ball), K4 (NTT), the int8 GEMMs and the rest (PyTorch's own kernels,
copies and fills), and the device's busy share of that run (device time
over the run's wall time on the host clock, profiler on); then one JSON
line. `chip_smoke.py` phase 5 prints the same breakdown for its own
queue, and phase 7 the breakdown of one `verify_mxu` call (`profile_call`).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# device-time groups: (group, substring of the kernel's name)
GROUPS = (("K1 sponge", "sponge_kernel"), ("K2 mask limbs", "mask_limbs_kernel"),
          ("K3 ball", "ball_kernel"), ("K4 ntt", "ntt_kernel"))
OTHER_GROUPS = ("int8 GEMMs", "rest")
SEED, QUEUE, WINDOW = 2026, 16384, 768


def profile_call(fn):
    """Run fn() once under torch.profiler (CUDA activity). Return (its
    result, {group: device us}, busy share: device time over the call's
    wall time, {kernel name: device us} of the group "rest"), with None for
    the last three when the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return out, None, None, None
    us = dict.fromkeys([g for g, _ in GROUPS] + list(OTHER_GROUPS), 0.0)
    rest = {}
    for e in events:
        name = e.name.lower()
        group = next((g for g, key in GROUPS if key in name), "int8 GEMMs" if "gemm" in name else "rest")
        us[group] += e.time_range.elapsed_us()
        if group == "rest":
            rest[e.name] = rest.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out, us, sum(us.values()) / wall_us, rest


def profile_rounds(signer, mus: torch.Tensor, ref_sig: torch.Tensor):
    """Run signer(mus) once under torch.profiler (CUDA activity). Return
    ({group: device us per round}, busy share, rounds), or None if the
    profiler recorded no device event. Raises if the signatures differ
    from ref_sig."""
    res, us, busy, _ = profile_call(lambda: signer(mus))
    if not torch.equal(res.sig, ref_sig):
        raise AssertionError("the profiled run gave other signatures")
    if us is None:
        return None
    return {g: v / res.rounds for g, v in us.items()}, busy, res.rounds


def describe(per_round: dict, busy: float, rounds: int) -> str:
    groups = ", ".join(f"{g} {v:.1f} us" for g, v in per_round.items())
    return (f"device time per round ({rounds} rounds) {groups}; total {sum(per_round.values()):.1f} us; "
            f"busy share {busy:.4f}")


def main() -> int:
    from dilithium_tpu_torch import mxu, scheme
    from dilithium_tpu_torch.params import get_params

    if not torch.cuda.is_available():
        print("round_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    p = get_params(3)
    rng = np.random.default_rng(SEED)
    seed = torch.from_numpy(rng.integers(0, 256, 32, dtype=np.uint8)).to(dev)
    mus = torch.from_numpy(rng.integers(0, 256, (QUEUE, 64), dtype=np.uint8)).to(dev)
    kp = scheme.keygen(seed, p)
    signer = mxu.MxuSigner(mxu.build_operators(kp.sk, p), p, window=WINDOW)
    ref = signer(mus)
    signer(mus)
    if not bool(ref.ok.all()):
        raise AssertionError("a signature is not ok")
    out = profile_rounds(signer, mus, ref.sig)
    if out is None:
        print("round_profile: the profiler recorded no device events", file=sys.stderr)
        return 1
    per_round, busy, rounds = out
    print(f"round_profile Q={QUEUE} W={WINDOW}: {describe(per_round, busy, rounds)}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "queue": QUEUE, "window": WINDOW,
                      "rounds": rounds, "us_per_round": per_round, "busy_share": busy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
