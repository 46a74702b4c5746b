"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`), from the root of a checkout. It sets
the cell up from the seed, warms it, drives it for --seconds, compares
what the window produced with the reference, and prints the check lines
last on stderr and one JSON result line last on stdout: the cell's
end-to-end metrics untraced, its per-layer metrics with --trace 1.

Exits non-zero without a result line when there is no CUDA card, when
the machine has fewer cards than the cell asks for, when the program is
missing, or when JAX or the JAX package got loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root holds the packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def seed_arg(text: str) -> int:
    n = int(text)
    if n < 0:
        raise argparse.ArgumentTypeError("the seed is a whole number >= 0")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=seed_arg, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = harness.load_cell(args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
                    f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    name, limit = harness.card("cuda")
    harness.log(f"card: {name}, power limit {limit} W; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except ImportError as e:
        harness.log(f"benchmark: {e}")
        return 3
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
