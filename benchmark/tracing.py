"""The traced stretch of a run: `torch.profiler` over a few calls inside
the window, reduced to sums as soon as it stops (a whole trace of the
round loop would be hundreds of MB).

`Profiled` wraps the calls; `summarize` reads the profiler's events once
and keeps:
  window_s   the traced stretch: first call's start to last call's end;
  busy_s     the union of device activity (kernels, copies, fills) in it;
  calls, answered   what the stretch did;
  launches   kernels that ran on the device;
  device_s   device seconds by kernel (or copy) name;
  gemm_names kernels launched under `aten::_int_mm`;
  int_mm     `aten::_int_mm` launches by (m, k, n), from record_shapes;
  shapes     the port's own launch counter (`_kernels.SHAPES`) over the
             stretch: launches by kernel and scalar arguments;
  device_ops the 10 device ops that took most time;
  idle_gaps  the device's idle time by the host op that was running in
             the middle of each gap (the innermost one), the 10 largest.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict

import torch

CALL_SPAN = "benchmark.call"
TOP = 10
NAME_CHARS = 160

# the port's hand-written kernels, by their __global__ function names
PORT_KERNELS = {
    "K1": re.compile(r"\bsponge_kernel\b"),
    "K2": re.compile(r"\bmask_limbs_kernel\b"),
    "K3": re.compile(r"\bball_kernel\b"),
    "K4": re.compile(r"\b(block|warp)_ntt_kernel\b"),
    "K5": re.compile(r"\bpermute_kernel\b"),
    "K6": re.compile(r"\bsponge_planes(_pair)?_kernel\b"),
    "K7": re.compile(r"\bball_bitplane_kernel\b"),
}
ROOFLINE_KERNELS = ("K1", "K2", "K3", "K4")


def port_kernel(name: str):
    """"K1".."K7" for one of the port's kernels, else None."""
    return next((k for k, rx in PORT_KERNELS.items() if rx.search(name)), None)


def group(name: str, gemm_names) -> str:
    """The group a device op's time goes to: a port kernel (K1-K7),
    "int8_gemm", "transfer" (copies between host and device) or "glue"
    (every other PyTorch kernel, device copy and fill)."""
    k = port_kernel(name)
    if k:
        return k
    if name in gemm_names:
        return "int8_gemm"
    if "HtoD" in name or "DtoH" in name:
        return "transfer"
    return "glue"


def group_seconds(summary: dict) -> Counter:
    out: Counter = Counter()
    gemm = set(summary["gemm_names"])
    for name, s in summary["device_s"].items():
        out[group(name, gemm)] += s
    return out


class Profiled:
    """Profile the calls made inside `with Profiled(...) as p:`; each call
    goes through `p.call(fn)`. On exit, the summary is in `p.summary`."""

    def __init__(self, counter=None):
        self.counter = counter  # a Counter the program adds its launches to, or None
        self.calls = 0
        self.answered = 0
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        if self.counter is not None:
            self._before = Counter(self.counter)
        self._prof = profile(activities=acts, record_shapes=True)
        self._prof.__enter__()
        return self

    def call(self, fn):
        with torch.profiler.record_function(CALL_SPAN):
            n = fn()
        self.calls += 1
        self.answered += n
        return n

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            shapes = Counter(self.counter) - self._before if self.counter is not None else Counter()
            self.summary = summarize(self._prof, self.calls, self.answered, shapes)
        return False


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(prof, calls: int, answered: int, shapes: Counter) -> dict:
    events = prof.profiler.kineto_results.events()
    spans, ops, device, int_mm_ids = [], [], [], set()
    int_mm: Counter = Counter()
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == CALL_SPAN:
                spans.append((e.start_ns(), e.end_ns(), e.start_thread_id()))
            else:  # an op, or a call into the CUDA runtime or driver
                ops.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
                sh = e.shapes()
                if name == "aten::_int_mm" and len(sh) >= 2 and len(sh[0]) == 2 and len(sh[1]) == 2:
                    int_mm_ids.add(e.correlation_id())
                    int_mm[(sh[0][0], sh[0][1], sh[1][1])] += 1
        elif "(" in name:  # a kernel, copy or fill; a range on the device (a span's shadow, "nccl:all_reduce") has no "("
            kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
            device.append((e.start_ns(), e.end_ns(), name, kind, e.linked_correlation_id()))
    if not spans:
        return None
    t0, t1 = min(s[0] for s in spans), max(s[1] for s in spans)
    device = [d for d in device if d[1] > t0 and d[0] < t1]
    if not device:
        return None
    device_s: Counter = Counter()
    gemm_names = set()
    for start, end, name, kind, linked in device:
        device_s[name] += (end - start) / 1e9
        if kind == "kernel" and (linked in int_mm_ids or ("gemm" in name.lower() and not port_kernel(name))):
            gemm_names.add(name)

    # the union of device activity, and the gaps between, inside [t0, t1]
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for start, end, *_ in sorted(device):
        start, end = max(start, t0), min(end, t1)
        if cur_e is None:
            gaps.append((t0, start))
            cur_s, cur_e = start, end
        elif start > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    gaps.append((cur_e, t1))
    idle_by_op = _gaps_by_host_op([g for g in gaps if g[1] > g[0]], ops, spans[0][2])

    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "calls": calls,
        "answered": answered,
        "launches": sum(1 for d in device if d[3] == "kernel"),
        "device_s": dict(device_s),
        "gemm_names": sorted(gemm_names),
        "int_mm": {f"{m}x{k}x{n}": c for (m, k, n), c in int_mm.items()},
        "shapes": {"|".join(map(str, key)): c for key, c in shapes.items()},
        "device_ops": [[_short(n), s] for n, s in device_s.most_common(TOP)],
        "idle_gaps": [[_short(n), s] for n, s in idle_by_op.most_common(TOP)],
    }


def _gaps_by_host_op(gaps, ops, thread) -> Counter:
    """Seconds of idle device time by the innermost host op (of the
    calling thread) running at each gap's midpoint."""
    ops = sorted((o for o in ops if o[3] == thread), key=lambda o: (o[0], -o[1]))
    out: Counter = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:  # in time order
        mid = (g0 + g1) // 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "(host outside any op)"] += (g1 - g0) / 1e9
    return Counter(out)


def idle_share(summary):
    """1 - busy / window of the traced stretch, or None."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 1 - summary["busy_s"] / summary["window_s"]


def glue_us_per_answer(summary):
    """Device microseconds of the glue group per answer, or None."""
    if not summary or not summary["answered"]:
        return None
    return group_seconds(summary)["glue"] * 1e6 / summary["answered"]
