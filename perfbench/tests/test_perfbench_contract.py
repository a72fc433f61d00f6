"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re

import pytest

from perfbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        names.append(entry["name"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in harness.end_to_end(BENCH, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert harness.per_layer(BENCH, w["name"]), w["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in harness.end_to_end(BENCH, cell)], (m, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    workload, config = harness.cell(cell)
    assert workload["config"] == entry["config"] == config["name"]
    assert (harness.HERE / "drivers" / f"{workload['driver']}.py").is_file()
    assert (harness.HERE / "reference" / f"{config['reference']}.py").is_file()
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"perfbench/configs/{entry['config']}.json"
    assert json.loads((harness.ROOT / conf["file"]).read_text())["reduced"] == conf["reduced"]
    for m in harness.per_layer(BENCH, cell):
        module = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(module.read)
        assert module.read({}) is None  # nothing to read: no number, never 0
    assert workload["limits"] and all(v >= 0 for v in workload["limits"].values())


def test_full_check_fits_the_day():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
