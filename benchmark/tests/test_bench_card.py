"""On the card: one short run of each one-card cell at a small batch,
untraced and traced, through the harness (run on the card with
`python -m pytest benchmark/tests -m card`; skips without one)."""

import pytest
import torch

from benchmark import harness

SMALL = {
    "d3-sign": {"batch": 256, "distinct_calls": 4},
    "d3-verify": {"batch": 256, "distinct_calls": 4},
    "d2-sign-interactive": {"distinct_calls": 64},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for trace in (False, True):
        line = harness.run_cell(cell, 2718281828, 2.0, trace, device="cuda", overrides=SMALL[cell])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
        assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(cell, trace)}
        if trace:
            assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
