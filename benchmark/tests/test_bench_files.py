"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps to
the benchmark's contract: names, units, bounds, and what each cell reports."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
UNIT_CHARS = harness.NAME_CHARS | set("/%")


def _name_ok(name: str) -> bool:
    return (0 < len(name) <= 64 and set(name) <= harness.NAME_CHARS
            and (name[0].isalnum() or name[0] == "_"))


def test_benchmark_json_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    cell = harness.load_cell(name)
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cell["chips"] == 1
    drv = harness.driver(cell["driver"])
    for fn in ("setup", "unit", "check"):
        assert callable(getattr(drv, fn))
    assert drv.RATE in {m["name"] for m in SPEC["end_to_end"]}
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    spec = harness.load_json(harness.ROOT / config["file"])
    assert spec["name"] == config["name"]
    assert config["file"].startswith("benchmark/configs/")
    assert set(config["reduced"]) == set(spec["reduced"])
    for key in config["reduced"]:
        assert _name_ok(key) and not key.endswith(("_dim", "_rank"))
    assert spec["width_multiplier"] == 1.0          # published widths


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert _name_ok(metric["name"])
    assert 0 < len(metric["unit"]) <= 16 and set(metric["unit"]) <= UNIT_CHARS
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert callable(harness.reader(metric["name"]).read)
        moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        # a per-layer metric is reported only in cells that report what it moves
        assert set(metric["workloads"]) <= set(moves.get("workloads", CELLS))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_enough(name):
    e2e, per_layer = harness.cell_metrics(name, SPEC)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


def _line_ok(text: str) -> bool:
    return 0 < len(text) <= 200 and not set(text) & set("\t\n\r")


def test_text_fields():
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert _line_ok(entry["why"])
    for entry in SPEC["configs"]:
        assert _line_ok(entry["source"])
    for entry in SPEC["per_layer"]:
        assert _line_ok(entry["layer"])
    for word in SPEC["command"]:
        assert _line_ok(word)
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, keys in allowed.items():
        for entry in SPEC[group]:
            assert set(entry) <= keys


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names)) and all(_name_ok(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    """A new traffic mix is a new cell file for an existing driver: the
    harness finds it by name with no file edited."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    cell = harness.load_json(root / "workloads" / f"{CELLS[0]}.json")
    cell["traffic"] = "ncut_b8"
    cell["params"]["batch_size"] = 8
    (root / "workloads" / "alternation.deeplabv3_r50_os8.ncut_b8.json").write_text(
        json.dumps(cell))
    monkeypatch.setattr(harness, "BENCH_DIR", root)
    found = harness.load_cell("alternation.deeplabv3_r50_os8.ncut_b8")
    assert found["params"]["batch_size"] == 8
    assert found["config_spec"]["name"] == "deeplabv3_r50_os8"
