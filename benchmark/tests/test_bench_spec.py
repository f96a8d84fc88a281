"""``BENCHMARK.json`` against the rules of its format: every cell
resolves to its files, every name and unit is of the allowed characters,
and every metric has a reader and is reported where it should be."""

import json
import re

import pytest

from benchmark import spec, traffic

SPEC = spec.load()
CELLS = [w["name"] for w in SPEC["workloads"]]
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec.SPEC.stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32
    assert SPEC["command"][1] == "benchmark/run.py"
    assert all(LINE.match(word) for word in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and LINE.match(entry["why"])
    w = spec.workload(SPEC, cell)
    assert w.config["name"] == entry["config"]
    assert w.traffic["entry"] in ("align_score", "align", "align_score_batch")
    e2e = {m.name for m in w.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and w.per_layer
    for m in w.per_layer:  # each per-layer metric moves a metric the cell reports
        moves = next(p["moves"] for p in SPEC["per_layer"] if p["name"] == m.name)
        assert moves in e2e


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        spec.check_name(e["name"])
        for key in ("config", "traffic"):
            if key in e:
                spec.check_name(e[key])
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_metric_entries():
    for e in SPEC["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        spec.reader(e["name"])
    for e in SPEC["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert not e["name"].endswith("_roofline") or e["unit"] == "%"
        spec.reader(e["name"])


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    with open(spec.config_file(SPEC, config)) as f:
        data = json.load(f)
    assert data["name"] == config and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    # every mode that the harness converts into the program's AlignMode
    assert data["mode"] in ("global", "local", "semiglobal", "infix")
    assert data["alphabet"] == [1, 4]
    assert any(w["config"] == config for w in SPEC["workloads"])


@pytest.mark.parametrize("name", sorted({w["traffic"] for w in SPEC["workloads"]}))
def test_traffic_files(name):
    with open(spec.traffic_file(name)) as f:
        data = json.load(f)
    assert data["pool"] >= 2 and data["pairs"] >= 1
    assert traffic.shapes(data).shape == (data["pairs"], 2)


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        spec.workload(SPEC, "no.such.cell")
    with pytest.raises(ValueError):
        spec.check_name("a name")
    with pytest.raises(ValueError):
        spec.reader("no_such_metric")
