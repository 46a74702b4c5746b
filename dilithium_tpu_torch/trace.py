"""The program's spans and counters, switched on by `torch.profiler`.

    with trace.span("api.sign"):
        ...
    trace.count("scheme.rounds", rounds)

Both record only while a `torch.profiler` session records; there is no
other switch. Outside one, `span` returns one shared no-op context and
`count` returns at once: one call to `_profiler_enabled` each, a small
fraction of what a bare `record_function` costs with no profiler.

While recording, a span enters `torch.profiler.record_function(name)`,
so it lands in the profiler's trace on the device's clock (a Chrome trace
from `export_chrome_trace` shows it above the kernels it launched), and
adds to in-memory totals: per name its count, total time and self time
(the total less the time under its child spans). torch keeps a
profiler's state per thread, so only the thread that started the session
records, and it alone writes the totals. `totals()` reads them back.
They start empty at the first span or count of a session, once that
thread has seen the profiler off since it last recorded: a span, count
or `totals()` call outside a session marks that, so two sessions with no
call into the program between them share one set. Nothing is written
anywhere.

Span names hold no "(": a profiler event on the device without one is a
range, not work, to the benchmark's trace reader (`benchmark/tracing.py`).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

recording = torch._C._autograd._profiler_enabled  # is a profiler session recording?


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_spans: dict = defaultdict(lambda: [0, 0, 0])  # name -> [n, total ns, self ns]
_counters: dict = defaultdict(int)
_stack: list = []  # the open spans, innermost last
_thread = threading.local()  # .off: this thread saw the profiler off since it last recorded


def _session() -> None:
    """Called while recording: start the totals afresh where this thread
    saw the profiler off since it last added to them."""
    if getattr(_thread, "off", True):
        _thread.off = False
        _spans.clear()
        _counters.clear()


class _Span:
    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _session()
        _stack.append(self)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        dt = time.perf_counter_ns() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child_ns += dt
        s = _spans[self.name]
        s[0] += 1
        s[1] += dt
        s[2] += dt - self.child_ns
        return False


def span(name: str):
    """A context manager: a profiler range and a timed total while a
    profiler session records, else a shared no-op."""
    if recording():
        return _Span(name)
    _thread.off = True
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a profiler session records."""
    if recording():
        _session()
        _counters[name] += int(n)
    else:
        _thread.off = True


def totals() -> dict:
    """{"spans": {name: {"n", "total_ms", "self_ms"}}, "counters": {name:
    n}} of the latest profiler session; empty where none recorded."""
    if not recording():
        _thread.off = True
    return {
        "spans": {k: {"n": n, "total_ms": t / 1e6, "self_ms": s / 1e6} for k, (n, t, s) in _spans.items()},
        "counters": dict(_counters),
    }
