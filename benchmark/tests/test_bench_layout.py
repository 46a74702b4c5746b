"""BENCHMARK.json and the files it names: every cell's mix names an
existing configuration and traffic kind and agrees with its entry, every
metric has its reader, every per-layer metric's `moves` is reported in
each of its cells, and the entries keep to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.traffic import common

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert os.path.exists(os.path.join(harness.ROOT, BENCH["command"][1]))
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry, mix, config = harness.load_cell(cell)
    assert {k: mix[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic", mix["kind"] + ".py"))
    assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
    assert config["name"] == entry["config"]
    # the configuration's parameters are the reference's for its level
    from benchmark.reference import dilithium as ref
    assert common.ref_params(config) == ref.PARAMS[config["level"]]
    reported = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_configs():
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])  # one source a deployment
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py")), m["name"]
        assert all(w in CELLS for w in m.get("workloads", []))
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_chips_budget():
    """One cell on four cards at most, a quarter of the cells rounded down
    or one."""
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
