"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for word in MANIFEST["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metrics_units_sources_and_moves():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        # every cell that reports the metric reports what it moves
        for cell in m["workloads"]:
            moved = run.cell_metrics(MANIFEST, cell, "end_to_end")
            assert m["moves"] in {x["name"] for x in moved}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in MANIFEST["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(MANIFEST, cell["name"],
                                                   "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(MANIFEST, cell["name"], "per_layer")
        assert cell["chips"] == 1
        assert 1 <= len(cell["why"]) <= 200


def test_configs_files_and_reduced():
    used = {c["config"] for c in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and len(c["source"]) <= 200
        assert data["reduced"] == c["reduced"] == []
        assert data["mfu_peak"] in ("tf32", "bf16")


@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_harness_finds_each_cell_by_name(cell):
    manifest, entry, config, traffic, limits = run.load_cell(cell)
    assert entry["name"] == cell
    assert (run.HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert limits and all(v >= 0 for v in limits.values())
    for m in run.cell_metrics(manifest, cell, "per_layer"):
        assert callable(run.metric_reader(m["name"]).read)


def test_metric_readers_return_nothing_without_a_trace():
    ctx = {"trace": None, "window_s": 1.0, "batches": 0, "pulled": 0,
           "steps": 0, "peak_bytes": 0}
    for m in MANIFEST["per_layer"]:
        assert run.metric_reader(m["name"]).read(ctx) is None


def test_judge_needs_every_number_within_its_limit():
    ok, out = run.judge({"a": 0.5, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert ok and out["a"] == {"value": 0.5, "limit": 1.0}
    assert not run.judge({"a": 2.0, "b": 0.0}, {"a": 1.0, "b": 0.0})[0]
    assert not run.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not run.judge({}, {"a": 1.0})[0]
