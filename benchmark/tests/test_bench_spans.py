"""The readers of the program's spans and counters
(`benchmark/program_trace.py` and the metrics that use it) on synthetic
totals: each computes its definition, and returns None, without raising,
where the program has no `dilithium_tpu_torch.trace` (a checkout from
before it) or its totals are empty."""

import sys

import pytest

import dilithium_tpu_torch
from benchmark import harness
from dilithium_tpu_torch import trace

METRICS = {m["name"]: m for m in harness.spec()["per_layer"] if m["source"] in ("program_span", "program_counter")}


def _span(n, total_ms, self_ms=None):
    return {"n": n, "total_ms": total_ms, "self_ms": total_ms if self_ms is None else self_ms}


# two verify calls
VERIFY = {
    "spans": {
        "api.verify": _span(2, 300.0, 10.0),
        "api.coerce": _span(2, 90.0, 30.0),
        "api.mu": _span(2, 60.0),
        "api.h2d": _span(4, 5.0),
        "api.d2h": _span(2, 50.0),
        "api.rows": _span(2, 20.0),
        "mxu.verify": _span(2, 125.0),
    },
    "counters": {},
}
# three sign calls: 7 rounds of W = 4 slots
SIGN = {
    "spans": {
        "api.sign": _span(3, 400.0, 6.0),
        "api.mu": _span(3, 33.0),
        "api.h2d": _span(3, 3.0),
        "mxu.sign_stream": _span(3, 300.0, 1.0),
        "scheme.round": _span(7, 299.0, 229.0),
        "scheme.sync": _span(7, 70.0),
        "api.d2h": _span(6, 40.0),
        "api.rows": _span(3, 18.0),
    },
    "counters": {"scheme.rounds": 7, "scheme.slots": 28, "scheme.attempts": 21},
}
WANT = {  # name -> (totals, value)
    # the api spans' self times but the copies', per call span
    "api.host_ms_per_verify_call": (VERIFY, (10.0 + 30.0 + 60.0 + 20.0) / 2),
    "api.host_ms_per_sign_call": (SIGN, (6.0 + 33.0 + 18.0) / 3),
    "scheme.host_us_per_round.sign": (SIGN, (299.0 - 70.0) * 1e3 / 7),
    "scheme.host_us_per_round.interactive": (SIGN, (299.0 - 70.0) * 1e3 / 7),
    "scheme.slot_yield": (SIGN, 21 / 28),
    "scheme.rounds_per_call": (SIGN, 7 / 3),
}


def test_every_reader_is_listed():
    assert set(WANT) == set(METRICS)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_synthetic_totals(name, monkeypatch):
    totals, value = WANT[name]
    monkeypatch.setattr(trace, "totals", lambda: totals)
    assert harness._reader(name)(None) == pytest.approx(value)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_empty_totals(name, monkeypatch):
    monkeypatch.setattr(trace, "totals", lambda: {"spans": {}, "counters": {}})
    assert harness._reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_module(name, monkeypatch):
    monkeypatch.delattr(dilithium_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "dilithium_tpu_torch.trace", None)  # import raises ImportError
    with pytest.raises(ImportError):
        from dilithium_tpu_torch import trace as _  # noqa: F401
    assert harness._reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_its_spans(name, monkeypatch):
    """Totals from another kind of call (a lone counter) give None."""
    monkeypatch.setattr(trace, "totals", lambda: {"spans": {"api.mu": _span(1, 1.0)}, "counters": {}})
    assert harness._reader(name)(None) is None
