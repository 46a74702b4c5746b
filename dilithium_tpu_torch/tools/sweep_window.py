"""Sweep the stream signer's window at one level.

The port of the root `tools/sweep_window.sh`: runs
`python -m dilithium_tpu_torch.bench` once a window (its whole protocol,
in its own process, the rest of the environment passed on: mode, batch,
iterations, device) and prints each window's block lines and JSON line,
prefixed "W=<window> ", then one JSON line:
{"level": l, "values": {window: value}, "best_window": w}. Each run's
`launches` and `shapes` lines (`bench.log_launches`) are passed on to
stderr.

    python -m dilithium_tpu_torch.tools.sweep_window [level] [windows...]

Defaults: level 3; windows 768 1536 2048 3072 4096 6144 8192, the widths
`scheme.DEFAULT_WINDOWS` was chosen from, and the level's default. Exits
1 when a run fails (its JSON line has no value) or exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from dilithium_tpu_torch import scheme
from dilithium_tpu_torch.params import get_params

WINDOWS = (768, 1536, 2048, 3072, 4096, 6144, 8192)
TIMEOUT_S = 2400


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    level = int(argv[0]) if argv else 3
    windows = [int(w) for w in argv[1:]] or sorted({*WINDOWS, scheme.default_window(get_params(level))})
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    values, failed = {}, []
    for w in windows:
        print(f"=== level {level} window {w} ===", flush=True)
        env = dict(os.environ, DILITHIUM_BENCH_LEVEL=str(level), DILITHIUM_BENCH_WINDOW=str(w),
                   PYTHONPATH=os.pathsep.join(x for x in (repo, os.environ.get("PYTHONPATH")) if x))
        proc = subprocess.run([sys.executable, "-m", "dilithium_tpu_torch.bench"], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=TIMEOUT_S)
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith(("block:", "blocks:"))]
        line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")), "{}")
        for ln in lines + [line]:
            print(f"W={w} {ln}", flush=True)
        for ln in proc.stderr.splitlines():
            if ln.startswith(("launches ", "shapes ")):
                print(ln, file=sys.stderr, flush=True)
        value = json.loads(line).get("value")
        if proc.returncode != 0 or value is None:
            print(f"W={w} failed (exit {proc.returncode}): {proc.stderr[-2000:]}", file=sys.stderr)
            failed.append(w)
        else:
            values[w] = value
    best = max(values, key=values.get) if values else None
    print(json.dumps({"level": level, "values": values, "best_window": best}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
