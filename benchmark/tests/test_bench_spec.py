"""``BENCHMARK.json`` keeps the contract's form, and the harness finds every
cell's files and every metric's reader by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.ROOT)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][1] == "benchmark/run.py" and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {c["name"] for c in SPEC["workloads"]}
    reported = {c: {m["name"] for m in SPEC["end_to_end"] if c in m.get("workloads", cells)}
                for c in cells}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reported[c], (m["name"], c)
    for c in cells:  # setup_s, one more end-to-end metric and one per-layer metric
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_layers_named_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = harness.find_cell(SPEC, cell)
    config = harness.load_json(harness.config_file(SPEC, entry["config"]))
    traffic = harness.load_json(harness.traffic_file(entry["traffic"]))
    limits = harness.load_json(harness.limits_file(cell))
    assert config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == entry["config"])
    drv = harness.driver(traffic["kind"])
    assert all(hasattr(drv, f) for f in ("setup", "window", "judge"))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_configs_used_and_files_under_paths():
    used = {c["config"] for c in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
