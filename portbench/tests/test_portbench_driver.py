"""The train driver and the reference on the CPU at tiny sizes: they
agree, and each fault a training cell can have turns ``correct`` false
under the cell's own limits."""

import json
import os
import time

import pytest

from portbench import check, harness
from tinycells import ROOT, tiny_root

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(tiny_root(str(tmp_path_factory.mktemp("tiny"))))


def run(bench, cell, fault=None, seed=SEED):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", "0.2", "--trace", "0"])
    rec = harness.execute(bench, args, time.time(), "cpu", fault)
    return rec, harness.result(bench, rec, {"platform": "cpu"})


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(bench, cell):
    rec, out = run(bench, cell)
    assert out["correct"] is True
    # float32 on both sides: far inside any limit
    assert all(c.value < 1e-4 for c in rec.checks), rec.checks
    assert rec.attempted >= 1 and rec.failed == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(check.NUMBERS)
    assert {"train_tokens_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_fault_is_not_correct(bench, cell, fault):
    rec, out = run(bench, cell, fault)
    assert out["correct"] is False, rec.checks


def test_the_same_seed_gives_the_same_run(bench):
    a, _ = run(bench, CELLS[0], seed=5)
    b, _ = run(bench, CELLS[0], seed=5)
    assert [c.value for c in a.checks] == [c.value for c in b.checks]
