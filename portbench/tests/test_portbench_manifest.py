"""`BENCHMARK.json` against the benchmark's contract and its files."""

import json
import re
import shutil

import pytest

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cells_of(metric):
    return metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_time_budget_fits_with_24_cells():
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    body = harness.config(cfg["name"])
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert LINE.match(cfg["source"]) and LINE.match(cfg["why"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    body = harness.workload(cell["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert body[key] == cell[key]
    assert cell["chips"] == 1 and LINE.match(cell["why"])
    tr = harness.traffic(cell["traffic"])
    drv = harness.driver(tr["driver"])
    for fn in ("setup", "unit", "traced", "end_to_end", "attempted_failed", "check"):
        assert callable(getattr(drv, fn))
    assert hasattr(drv, "CONTROL_CONFIG") or (callable(drv.control) and callable(drv.control_state))
    e2e, per_layer = harness.cell_metrics(BENCH, cell["name"], drv.E2E)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert set(e2e) - {"setup_s"} <= set(drv.E2E)
    assert set(body["limits"]) and all(v >= 0 for v in body["limits"].values())


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric["name"] in E2E:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert LINE.match(metric["layer"])
        moved = E2E[metric["moves"]]
        # the metric's cells all report the end-to-end metric it moves
        assert set(_cells_of(metric)) <= set(_cells_of(moved))
        assert metric["name"].replace(".", "_").isidentifier() or NAME.match(metric["name"])
        assert hasattr(harness.metric_reader(metric["name"]), "read")
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(_cells_of(metric)) <= set(CELLS)


def test_every_cell_reports_setup_and_another_and_a_layer_metric():
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if cell in _cells_of(m)]
        layer = [m for m in BENCH["per_layer"] if cell in _cells_of(m)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer


def test_layers_named_alike():
    """Metrics of one layer give the same layer name, letter for letter."""
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_harness_finds_a_cell_it_was_not_told_of(tmp_path, monkeypatch):
    """A cell added as a data file alone (and not named in
    `BENCHMARK.json`) is found by name, with the driver's metrics."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    new = dict(harness.workload("ar.fit-p4-4096"))
    new.pop("name")
    (copy / "workloads" / "ar.fit-p4-2048.json").write_text(json.dumps(new))
    monkeypatch.setattr(harness, "HERE", copy)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    wl = harness.workload("ar.fit-p4-2048")
    assert wl["traffic"] == "fit-p4-4096"
    e2e, per_layer = harness.cell_metrics(None, "ar.fit-p4-2048", ("fit_s",))
    assert e2e == ["setup_s", "fit_s"] and per_layer == []
    e2e, per_layer = harness.cell_metrics(BENCH, "ar.fit-p4-2048", ("fit_s",))
    assert e2e == ["setup_s", "fit_s"]
    assert "dev.idle_share.fit" not in per_layer  # listed for named cells only
    with pytest.raises(FileNotFoundError):
        harness.workload("ar.fit-p4-1")
    with pytest.raises(ValueError):
        harness.workload("../BENCHMARK")
