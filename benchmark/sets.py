"""Run one cell as sets of runs and print each metric's spread: how the
bounds in BENCHMARK.json are measured.

    python3 benchmark/sets.py --workload d3-sign --seconds 20 --sets 2 \\
        --seeds 3000000001 3000000002 ... [--trace 1] [--out FILE]

Each run is a fresh process of `benchmark/run.py`; each set runs every
seed once, in order, and the sets repeat the same seeds. For each
metric and set it prints the median and the spread: the distance
between the first and third quartiles (`statistics.quantiles(values,
n=4)`) over the median. With --out, every result line is appended to
FILE as JSON with its set, seed, exit code and wall time.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = {}  # (set, metric) -> values
    bad = 0
    for s in range(args.sets):
        for seed in args.seeds:
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, RUN, "--workload", args.workload, "--seed", str(seed),
                                   "--seconds", str(args.seconds), "--trace", str(args.trace)],
                                  capture_output=True, text=True)
            wall = time.perf_counter() - t
            lines = proc.stdout.strip().splitlines()
            line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            if line is None or not line["correct"]:
                bad += 1
                print(f"set {s} seed {seed}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            if line is not None:
                vals = {k: v["value"] for k, v in line["metrics"].items()}
                print(f"set {s} seed {seed}: correct {line['correct']} wall {wall:.1f} s {vals} "
                      f"checks {line['checks']}", flush=True)
                for k, v in vals.items():
                    results.setdefault((s, k), []).append(v)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"workload": args.workload, "set": s, "seed": seed, "rc": proc.returncode,
                                        "wall_s": wall, "line": line}) + "\n")
    for (s, k), vals in sorted(results.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        sp = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{k} set {s}: n {len(vals)} median {statistics.median(vals)} spread {sp} values {vals}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
