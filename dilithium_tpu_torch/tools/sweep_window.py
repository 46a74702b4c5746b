"""Sweep the stream signers' window W on one device, in one process.

`scheme.DEFAULT_WINDOWS` (the window a signer runs when it is given
window=None) is chosen with this tool: run it at each level on the four
paths, and take the W whose signs/s is best where the paths agree.

    python -m dilithium_tpu_torch.tools.sweep_window [--level 3] [--path mxu]
        [--windows W ...] [--queue 16384] [--calls 2] [--readings 3]
        [--nkeys 256] [--device cuda]

Paths, each signing a queue of Q items a call, deterministically:
  bytes   `api.Signer(level, sk, mode="mxu").sign` on Q 59-byte messages
          (mu hashed on the host, signatures back as bytes);
  mxu     `mxu.sign_stream_mxu` on Q mu rows on the device under one
          key's operators, the signatures left there;
  keys    `api.MultiSigner(level, sks).sign` on Q (key, 59-byte message)
          pairs, each key drawn uniformly from NKEYS;
  stream  `scheme.sign_stream` on Q mu rows on the device under one
          `expand_sk` key, the signatures left there.

Keys and inputs come from a fixed seed. A path's key expansion is made
once and reused at every W. Each W first signs the queue once untimed;
its signatures must equal the first W's, byte for byte, or the tool exits
1. Then each reading times CALLS calls at every W in turn (host clock,
the device synchronised), so a slow stretch of the host or card hits
every W alike. Prints one JSON line:
{"level", "path", "device", "queue", "values": {W: median signs/s over
the readings}, "spread": {W: IQR / median}, "best_window"}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from dilithium_tpu_torch import api, mxu, scheme
from dilithium_tpu_torch.params import SEEDBYTES, TRBYTES, get_params

PATHS = ("bytes", "mxu", "keys", "stream")
WINDOWS = (768, 1536, 2048, 3072, 4096, 6144, 8192)
MSG_LEN = 59  # the benchmark's d3-sign messages
SEED = 0


class Case(NamedTuple):
    """One path set up: sign(window) signs the queue once, as the path's
    callers do (bytes out of the api paths, a SignResult on the device
    out of the others), and rows(its result) gives the signatures, uint8
    [Q, sig_bytes]; sks holds the keys (bytes) and key_of_row and mus each
    row's key index and mu, for a check against a reference."""
    sign: Callable[[int], object]
    rows: Callable[[object], np.ndarray]
    sks: list
    key_of_row: np.ndarray
    mus: np.ndarray


def setup(path: str, level: int, queue: int, nkeys: int = 256, device="cuda") -> Case:
    """Keys and a queue from SEED, and the path's key expansion, made once."""
    if path not in PATHS:
        raise ValueError(f"path {path!r}: use one of {PATHS}")
    dev = torch.device(device)
    p = get_params(level)
    rng = np.random.default_rng(SEED)
    n = nkeys if path == "keys" else 1
    seeds = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    _, sks = api.keygen(level, [s.tobytes() for s in seeds], device=dev)
    key_of_row = rng.integers(0, n, queue) if path == "keys" else np.zeros(queue, dtype=np.int64)
    msgs = [m.tobytes() for m in rng.integers(0, 256, (queue, MSG_LEN), dtype=np.uint8)]
    trs = [sks[k][2 * SEEDBYTES:2 * SEEDBYTES + TRBYTES] for k in key_of_row]
    mus = api.compute_mu_many(trs, msgs)

    def rows(sigs: list) -> np.ndarray:
        return np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(queue, p.sig_bytes)

    if path == "bytes":
        signer = api.Signer(level, sks[0], mode="mxu", device=dev)

        def sign(window):
            signer.window = window
            return signer.sign(msgs)
        return Case(sign, rows, sks, key_of_row, mus)
    if path == "keys":
        multi = api.MultiSigner(level, sks, device=dev)
        pairs = list(zip(key_of_row.tolist(), msgs))

        def sign(window):
            multi.window = window
            return multi.sign(pairs)
        return Case(sign, rows, sks, key_of_row, mus)

    sk = torch.from_numpy(np.frombuffer(sks[0], dtype=np.uint8).copy()).to(dev)
    mu = torch.from_numpy(mus).to(dev)
    if path == "mxu":
        ops = mxu.build_operators(sk, p)

        def sign(window):
            return mxu.sign_stream_mxu(ops, mu, p, window=window)
    else:
        ek = scheme.expand_sk(sk, p)

        def sign(window):
            return scheme.sign_stream(ek, mu, p, window=window)

    def sig_rows(res) -> np.ndarray:
        if not bool(res.ok.all()):
            raise RuntimeError(f"{path}: a signature is not ok")
        return res.sig.cpu().numpy()
    return Case(sign, sig_rows, sks, key_of_row, mus)


def measure(case: Case, windows, calls: int, readings: int, device="cuda"):
    """Sign once untimed at every W, then time `calls` calls at every W in
    turn, `readings` times -> ({W: [signs/s of each reading]}, the first
    W's signatures, [the W whose signatures differ from them])."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    first = case.rows(case.sign(windows[0]))
    differ = [w for w in windows[1:] if not np.array_equal(case.rows(case.sign(w)), first)]
    queue = case.mus.shape[0]
    rates = {w: [] for w in windows}
    for _ in range(readings):
        for w in windows:
            sync()
            t = time.perf_counter()
            for _ in range(calls):
                case.sign(w)
            sync()
            rates[w].append(queue * calls / (time.perf_counter() - t))
    return rates, first, differ


def spread(xs) -> float:
    """IQR / median of xs, 0 for fewer than two."""
    if len(xs) < 2:
        return 0.0
    q1, q3 = np.percentile(xs, [25, 75])
    return float((q3 - q1) / statistics.median(xs))


def report(level: int, path: str, device, queue: int, rates: dict) -> dict:
    """The JSON line of a sweep, from `measure`'s rates."""
    dev = torch.device(device)
    values = {w: statistics.median(r) for w, r in rates.items()}
    return {"level": level, "path": path,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "queue": queue,
            "values": values, "spread": {w: spread(r) for w, r in rates.items()},
            "best_window": max(values, key=values.get)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dilithium_tpu_torch.tools.sweep_window", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--level", type=int, default=3, choices=(2, 3, 5))
    ap.add_argument("--path", default="mxu", choices=PATHS)
    ap.add_argument("--windows", type=int, nargs="+",
                    help="default: 768-8192 and the level's default window")
    ap.add_argument("--queue", type=int, default=16384, help="Q: messages a call")
    ap.add_argument("--calls", type=int, default=2, help="calls a reading")
    ap.add_argument("--readings", type=int, default=3)
    ap.add_argument("--nkeys", type=int, default=256, help="keys of the keys path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    windows = args.windows or sorted({*WINDOWS, scheme.default_window(get_params(args.level))})
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("sweep_window: no CUDA device is available (--device cpu runs the plain versions)", file=sys.stderr)
        return 1

    case = setup(args.path, args.level, args.queue, args.nkeys, dev)
    rates, _, differ = measure(case, windows, args.calls, args.readings, dev)
    print(json.dumps(report(args.level, args.path, dev, args.queue, rates)))
    if differ:
        print(f"sweep_window: the signatures at W = {differ} differ from those at W = {windows[0]}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
