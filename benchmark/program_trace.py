"""The program's own spans and counters over the traced stretch:
`dilithium_tpu_torch.trace` records them while a `torch.profiler` session
records, and keeps the totals of the latest session, which in a traced
run is the stretch `tracing.Profiled` profiles. The metrics that read
them (`metrics/api.*`, `metrics/scheme.host_us_per_round.*`,
`scheme.slot_yield`, `scheme.rounds_per_call`) come through here.

Each function returns None where the program has no such module (a
checkout from before it) or recorded nothing, and logs what it divides
on stderr."""

from __future__ import annotations

from benchmark.harness import log

# api spans that are copies and waits, not the api's own host work
API_COPIES = ("api.h2d", "api.d2h")


def totals():
    """{"spans": {name: {"n", "total_ms", "self_ms"}}, "counters": {...}}
    of the traced stretch, or None."""
    try:
        from dilithium_tpu_torch import trace
    except ImportError:
        return None
    t = trace.totals()
    return t if t["spans"] or t["counters"] else None


def api_host_ms_per_call(t, call: str):
    """The api layer's own host time per `call` span ("api.sign" or
    "api.verify"), in ms: the self time of every api span but the copies.
    With the api's spans all inside the call and none inside an mxu or
    scheme span, that is each call's duration less the time under
    api.h2d, api.d2h and the mxu and scheme spans."""
    if t is None:
        return None
    spans = t["spans"]
    n = spans.get(call, {}).get("n", 0)
    if not n:
        return None
    own = sum(s["self_ms"] for name, s in spans.items() if name.startswith("api.") and name not in API_COPIES)
    log(f"{call}: api host {own} ms over {n} calls")
    return own / n


def host_us_per_round(t):
    """Per scheme.round span: its duration less its scheme.sync, in us."""
    if t is None:
        return None
    r, s = t["spans"].get("scheme.round"), t["spans"].get("scheme.sync", {"total_ms": 0.0})
    if not r or not r["n"]:
        return None
    host = r["total_ms"] - s["total_ms"]
    log(f"scheme.round: {host} ms host (sync {s['total_ms']} ms) over {r['n']} rounds")
    return host * 1e3 / r["n"]


def counter_ratio(t, num: str, den: str, den_span: bool = False):
    """counter num / counter den (or, with den_span, the count of span
    den)."""
    if t is None:
        return None
    top = t["counters"].get(num)
    bottom = t["spans"].get(den, {}).get("n", 0) if den_span else t["counters"].get(den, 0)
    if top is None or not bottom:
        return None
    log(f"{num} {top} / {den} {bottom}")
    return top / bottom
