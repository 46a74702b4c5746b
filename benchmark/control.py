"""The controls of `correct`: each cell run with one guarantee of its
configuration broken in the program, which the cell's checks must catch.
Each traffic kind `benchmark/traffic/<kind>.py` holds its own control,
`control(ctx)`, a hook that patches the program in every process of the
run; its docstring says which guarantee it breaks.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

runs the cell once a seed, in this process, with its control, and prints
one JSON line a seed with the checks and `correct` (which has to be
false). The benchmark's own runs never load this module.
"""

import argparse
import importlib
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def control_for(name: str):
    """The control of cell `name`: its traffic kind's `control`."""
    kind = harness.load_cell(name)[1]["kind"]
    return importlib.import_module("benchmark.traffic." + kind).control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    hook = control_for(args.workload)
    for seed in args.seeds:
        line = harness.run_cell(args.workload, seed, args.seconds, False, hook=hook)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": hook.__module__,
                          "correct": line["correct"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
