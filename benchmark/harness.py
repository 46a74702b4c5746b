"""The benchmark's engine: finds a cell's files by name, runs its traffic
kind, reads its metrics and prints the result line.

A cell `<name>` is the entry of that name in `BENCHMARK.json`'s
`workloads`, its mix `workloads/<name>.json` (the traffic kind, its
parameters, the chips) and its configuration `configs/<config>.json`.
The traffic kind is the module `benchmark.traffic.<kind>`: its `run(ctx)`
sets the program up, warms it, drives the closed loop for ctx.seconds,
checks the outputs against the reference and returns an `Outcome`. Each
metric is a reader `metrics/<metric name>.py` with `read(outcome) ->
float or None`: end-to-end metrics in an untraced run, per-layer ones in a traced
run, each in the cells that `BENCHMARK.json` lists for it (every cell
where it lists none). A reader that finds nothing returns None, and the
metric is left out of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "dilithium_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def rng(seed: int, *tags: int) -> np.random.Generator:
    """An independent generator for each purpose (tags) of one seed."""
    return np.random.default_rng(np.random.SeedSequence([seed, *tags]))


@dataclass
class Context:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the card; "cpu" only in the CPU tests
    chips: int
    config: dict
    params: dict
    hook: Optional[Callable] = None  # called first in every process of the run (tests, controls)
    rank: int = 0  # the process's rank where a cell runs one process a card


@dataclass
class Outcome:
    attempted: int = 0  # answers requested in the window
    failed: int = 0  # of those, not given
    answered: int = 0
    window_s: float = 0.0  # first call's start to last call's end (the slowest rank's)
    window_start: float = 0.0  # time.perf_counter() at the first call's start
    latencies_s: list = field(default_factory=list)  # each call, host clock
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    trace: Optional[dict] = None
    extra: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    device_kind: str = "cpu"
    setup_s: float = 0.0  # process start to window_start


def forbidden_loaded() -> list:
    """The top-level names in FORBIDDEN that this process has loaded,
    compared whole (`dilithium_tpu_torch` is not `dilithium_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def closed_loop(ctx: Context, call, counter=None, trace_calls: int = 0, agree=None):
    """Run call(i) back to back (i = 0, 1, ...) for ctx.seconds; each
    returns the answers it gave. In a traced run, `trace_calls` calls from
    a third of the way in run under the profiler (and the window goes on
    until they have run). Where several processes run the loop together,
    agree(stop, begin) -> (stop, begin) makes them stop after the same
    call (all want to) and start tracing at the same call (one wants to).
    -> (per-call (start, end) on the host clock, answers, the error that
    stopped the loop or None, the trace summary)."""
    from benchmark.tracing import Profiled

    times, answered, error, summary = [], 0, None, None
    prof, traced, begin = None, 0, False
    to_trace = trace_calls if ctx.trace else 0
    start = time.perf_counter()
    i = 0
    while True:
        if begin:
            prof = Profiled(counter).__enter__()
        t0 = time.perf_counter()
        try:
            n = prof.call(lambda: call(i)) if prof is not None else call(i)
        except Exception as e:  # a failed call ends the window; its answers count as failed
            log("call %d failed:\n%s" % (i, traceback.format_exc()))
            error = e
            if prof is not None:
                prof.__exit__(type(e), e, e.__traceback__)
            break
        t1 = time.perf_counter()
        times.append((t0, t1))
        answered += n
        i += 1
        if prof is not None:
            traced += 1
            if traced == trace_calls:
                prof.__exit__(None, None, None)
                summary, prof = prof.summary, None
        stop = t1 - start >= ctx.seconds and traced == to_trace and prof is None
        begin = traced == 0 and prof is None and to_trace > 0 and t1 - start >= ctx.seconds / 3
        if agree:
            stop, begin = agree(stop, begin)
        if stop:
            break
    return times, answered, error, summary


def card(device: str) -> tuple:
    """(the card's name, its power limit in W or None)."""
    import torch

    if device != "cuda":
        return "cpu", None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        limit = float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        limit = None
    return torch.cuda.get_device_name(0), limit


def _reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    module = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(module)
    module.loader.exec_module(mod)
    return mod.read


def cell_metrics(name: str, trace: bool, bench: Optional[dict] = None) -> list:
    """The BENCHMARK.json metric entries that a run of cell `name`
    reports: end-to-end ones untraced, per-layer ones traced."""
    bench = bench or spec()
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def load_cell(name: str, bench: Optional[dict] = None) -> tuple:
    """(BENCHMARK.json's workload entry, the mix file, the configuration)."""
    bench = bench or spec()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    mix = load_json(BENCH_DIR, "workloads", name + ".json")
    config = load_json(BENCH_DIR, "configs", entry["config"] + ".json")
    return entry, mix, config


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None, hook: Optional[Callable] = None,
             t_start: Optional[float] = None) -> dict:
    """Run one cell once -> the result line (a dict). t_start: the
    process's start on time.perf_counter(), where set-up begins."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec()
    entry, mix, config = load_cell(name, bench)
    ctx = Context(name, seed, seconds, trace, device, entry["chips"], config,
                  {**mix["params"], **(overrides or {})}, hook)
    kind = importlib.import_module("benchmark.traffic." + mix["kind"])
    out = kind.run(ctx)
    out.setup_s = out.window_start - t_start
    log(f"set-up {out.setup_s} s; after the window (the reference's checks) "
        f"{time.perf_counter() - out.window_start - out.window_s} s; {out.extra}")
    leaked = forbidden_loaded()
    if leaked:
        raise ImportError(f"modules loaded in the run that must not be: {leaked}")

    metrics = {}
    for m in cell_metrics(name, trace, bench):
        value = _reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in {**out.checks, "failed": (out.failed, 0)}.items()}
    correct = out.attempted > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": out.device_kind, "count": ctx.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"], "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def print_result(line: dict) -> None:
    """The check lines last on stderr, then the result line last on
    stdout."""
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
