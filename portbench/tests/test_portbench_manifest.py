"""BENCHMARK.json against the benchmark's contract: names, units, the
files each entry needs, which cells report which metrics."""

import json
import math
import os
import re

import pytest

from portbench import check, harness

ROOT = harness.__file__.rsplit(os.sep, 2)[0]
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [x["name"] for x in
                                  MANIFEST["configs"] + MANIFEST["workloads"]
                                  + METRICS])
def test_names(name):
    assert NAME.match(name), name


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       metric["name"] + ".py"))
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200


def _reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    per_layer = [m for m in MANIFEST["per_layer"] if _reports(m, cell)]
    assert _reports(e2e["setup_s"], cell)
    assert sum(_reports(m, cell) for m in e2e.values()) >= 2
    assert per_layer
    for m in per_layer:
        assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files(cell):
    bench = harness.Bench(ROOT)
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    mix = bench.mix(cell["traffic"])
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       mix["driver"] + ".py"))
    assert set(bench.limits(cell["name"])) == set(check.NUMBERS)
    bench.config(cell["config"])


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_entry(entry):
    assert entry["name"] in {w["config"] for w in MANIFEST["workloads"]}
    assert entry["file"].startswith("portbench/")
    conf = json.load(open(os.path.join(ROOT, entry["file"])))
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                   entry["reduced"])
    for key in ("assumed", "departures", "deployment", "port", "reference"):
        assert key in conf


def test_manifest_size():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_no_bound_is_nan():
    assert all(math.isfinite(m["bound"]) for m in MANIFEST["end_to_end"])
