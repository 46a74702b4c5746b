"""A/B of this checkout's K1 (sponge), K2 (mask limbs), K3 (ball) and K4
(NTT) against other checkouts', on one card, at the signing path's shapes
and at large batch.

    python -m dilithium_tpu_torch.tools.kernel_ab OTHER [OTHER ...]

Each OTHER is the root of another checkout of the repo (a `git archive` of
an earlier commit, say), named by its directory's name. Its
`dilithium_tpu_torch/_kernels.py` is loaded under another module name and
builds that checkout's `csrc/` into that checkout's own build directory.
The C entry points `dk_sponge`, `dk_mask_limbs`, `dk_ball` and `dk_ntt`
have the same signatures on every side, so all run on the same inputs
into their own output buffers: the outputs must be bit-equal, then each
side's device-only time of one call (`bench_kernels.device_ms`, 20 calls
a timing) is taken in turns, the order reversed every round, for ROUNDS
rounds. Launches made here are not counted in `_kernels.LAUNCHES`.
Prints a table to stderr and one JSON line to stdout.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import statistics
import sys

import numpy as np
import torch

from dilithium_tpu_torch import _kernels
from dilithium_tpu_torch.bench_kernels import device_ms
from dilithium_tpu_torch.ops import keccak, ntt
from dilithium_tpu_torch.params import Q, SHAKE256_RATE, get_params

W_MAIN, Q_MAIN = 768, 16384
NTT_BATCHES = (1, 30, 512, 1024, 4096, 65536)
ROUNDS = 3


def load_other(root: str, name: str):
    """The kernel library of the checkout at root (built there on first use)."""
    path = os.path.join(root, "dilithium_tpu_torch", "_kernels.py")
    spec = importlib.util.spec_from_file_location(f"kernels_of_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def _checked(fn):
    def call():
        err = fn()
        if err != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {err}")
    return call


def run(other_roots, seed: int = 2026) -> dict:
    dev = torch.device("cuda", 0)
    libs = {}
    for root in other_roots:
        name = os.path.basename(os.path.normpath(root))
        if name in libs or name == "this":
            raise ValueError(f"two sides named {name!r}")
        libs[name] = load_other(root, name)
    libs["this"] = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(seed)
    p = get_params(3)
    cases = {}
    for label, b, n, out_bytes in (  # the SHAKE256 calls of the Dilithium-3 signing path
        ("c_tilde", W_MAIN, 64 + p.K * p.polyw1_packedbytes, 32),
        ("ball_stream", W_MAIN, 32, p.ball_blocks * SHAKE256_RATE),
        ("rhoprime", Q_MAIN, 96, 64),
    ):
        msg = torch.from_numpy(rng.integers(0, 256, (b, n), dtype=np.uint8)).to(dev)
        outs = {side: (torch.empty((b, out_bytes), dtype=torch.uint8, device=dev),) for side in libs}
        cases[f"sponge {label} [{b}, {n}] -> {out_bytes}"] = (outs, {
            side: _checked(lambda lib=lib, m=msg, o=outs[side][0], b=b, n=n, ob=out_bytes: lib.dk_sponge(
                m.data_ptr(), o.data_ptr(), b, n, ob, SHAKE256_RATE, 0x1F, stream))
            for side, lib in libs.items()})
    rp = torch.from_numpy(rng.integers(0, 256, (W_MAIN, 64), dtype=np.uint8)).to(dev)
    kappa = torch.from_numpy(rng.integers(0, 400, W_MAIN).astype(np.int32) * p.L).to(dev)
    outs = {side: (torch.empty((3, W_MAIN, p.L * 256), dtype=torch.int8, device=dev),) for side in libs}
    cases[f"mask_limbs W={W_MAIN} L={p.L}"] = (outs, {
        side: _checked(lambda lib=lib, o=outs[side][0]: lib.dk_mask_limbs(
            rp.data_ptr(), kappa.data_ptr(), o.data_ptr(), W_MAIN, p.L, p.gamma1_bits, p.gamma1, stream))
        for side, lib in libs.items()})

    nbytes = p.ball_blocks * SHAKE256_RATE
    for b in (W_MAIN, Q_MAIN):  # the signer's window, and the kernel bench's batch
        st = keccak.sponge_plain(torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev),
                                 nbytes, SHAKE256_RATE, 0x1F)
        outs = {side: (torch.empty((b, 256), dtype=torch.int32, device=dev),
                       torch.empty((b,), dtype=torch.bool, device=dev)) for side in libs}
        cases[f"ball level 3 B={b}"] = (outs, {
            side: _checked(lambda lib=lib, o=outs[side], st=st, b=b: lib.dk_ball(
                st.data_ptr(), o[0].data_ptr(), o[1].data_ptr(), b, p.tau, nbytes, stream))
            for side, lib in libs.items()})
    ztab = ntt._ztab_on(dev).data_ptr()
    # the path's 5-30 polynomials, both sides of K4's switch between its
    # block and warp kernels (512), and the kernel bench's batch
    for b, inverse in itertools.product(NTT_BATCHES, (False, True)):
        x = torch.from_numpy(rng.integers(0, Q, (b, 256)).astype(np.int32)).to(dev)
        g = ntt._SCALE_PLAIN if b == 30 else ntt._SCALE_PRODUCT  # [30, 256]: as chip_smoke's primary row
        gs = int(ntt._shoup(np.array([g]))[0])
        outs = {side: (torch.empty_like(x),) for side in libs}
        cases[f"ntt {'inverse' if inverse else 'forward'} [{b}, 256]"] = (outs, {
            side: _checked(lambda lib=lib, o=outs[side][0], x=x, b=b, inv=int(inverse), g=g, gs=gs: lib.dk_ntt(
                x.data_ptr(), o.data_ptr(), b, ztab, inv, g, gs, stream))
            for side, lib in libs.items()})

    rows = {}
    for name, (outs, fns) in cases.items():
        for out in outs.values():
            for t in out:
                t.zero_()
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        differ = [side for side in fns
                  if not all(torch.equal(a, b) for a, b in zip(outs[side], outs["this"]))]
        if differ:
            raise AssertionError(f"{name}: {differ} differ from this checkout")
        rows[name] = {side: [] for side in fns}
        order = list(fns)
        for _ in range(ROUNDS):
            for side in order:
                rows[name][side].append(device_ms(fns[side]))
            order.reverse()
        med = {side: statistics.median(ms) for side, ms in rows[name].items()}
        print(f"{name:36s} " + "  ".join(
            f"{side} {med[side]:.4f} ms ({med[side] / med['this']:.2f}x this) {[round(x, 4) for x in ms]}"
            for side, ms in rows[name].items()) + "  (device-only ms per call)", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="+", help="root of another checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    rows = run(args.other)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "unit": "device-only ms per call",
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
