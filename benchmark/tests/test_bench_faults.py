"""Whole runs of every cell on the CPU at small sizes (the harness's look
for a card skipped): sound, they come out correct; with a fault planted
in the program under the timed path, or with the cell's control
(`benchmark/control.py`), `correct` comes out false."""

import pytest

from benchmark import control, harness
from benchmark.tests import faults

SEED = 3141592653
SMALL = {
    "d3-sign": {"batch": 4, "distinct_calls": 3, "warm_calls": 1, "sample_per_call": 4, "max_checked": 16},
    "d3-verify": {"batch": 8, "distinct_calls": 3, "warm_calls": 1, "sample_per_call": 8, "max_checked": 32},
    "d2-sign-interactive": {"distinct_calls": 8, "warm_calls": 1, "max_checked": 8},
    "d3-sign-4chip": {"per_rank": 4, "distinct_calls": 2, "warm_calls": 1, "sample_per_call": 4, "max_checked": 8},
}
SECONDS = {"d2-sign-interactive": 3.0}  # sign_p95_ms reads 20 calls or more
# the faults each cell can have
FAULTS = {
    "d3-sign": [faults.altered_answers, faults.half_batch, faults.stale_answers],
    "d3-verify": [faults.altered_answers, faults.half_batch, faults.stale_answers, faults.all_invalid],
    "d2-sign-interactive": [faults.altered_answers, faults.stale_answers],
    "d3-sign-4chip": [faults.altered_answers, faults.half_batch, faults.stale_answers, faults.no_exchange],
}
CASES = [(cell, None) for cell in SMALL] + [(cell, f) for cell, fs in FAULTS.items() for f in fs] + [
    (cell, control.control_for(cell)) for cell in SMALL]


@pytest.fixture
def restore(monkeypatch):
    """Whatever a hook patches in this process is put back afterwards."""
    for obj, name in faults.PATCHED:
        monkeypatch.setattr(obj, name, getattr(obj, name))


@pytest.mark.parametrize("cell, hook", CASES, ids=[f"{c}-{h.__name__ if h else 'sound'}" for c, h in CASES])
def test_run(cell, hook, restore):
    line = harness.run_cell(cell, SEED, SECONDS.get(cell, 1.0), False, device="cpu", overrides=SMALL[cell], hook=hook)
    assert line["attempted"] > 0
    if hook is None:
        assert line["correct"], line["checks"]
        assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(cell, False)}
    else:
        assert not line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_forbidden_module_in_another_rank(restore):
    """A module of the JAX family loaded in rank 1 alone leaves the run
    without a result."""
    with pytest.raises(ImportError, match=r"rank\(s\) \[1\]"):
        harness.run_cell("d3-sign-4chip", SEED, 1.0, False, device="cpu", overrides=SMALL["d3-sign-4chip"],
                         hook=faults.jax_in_rank_one)
