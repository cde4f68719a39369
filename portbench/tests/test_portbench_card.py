"""On the card: the control (the reference with float8 products in the
program's place) is told apart from the program, at published widths cut
to a size a test run holds (2 layers, 1024 tokens a row).  Skips without
a CUDA device.  The readings the limits were set from come from
``portbench/calibrate.py`` at the cells' own sizes (PERF.md)."""

import copy
import time

import pytest

from portbench import calibrate, harness
from tinycells import ROOT

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def card_or_skip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def context(cell, seed):
    bench = harness.Bench(ROOT)
    w = bench.workload(cell)
    conf = copy.deepcopy(bench.config(w["config"]))
    conf["num_hidden_layers"] = 2
    mix = dict(bench.mix(w["traffic"]), seq_len=1024, batch=2)
    return harness.Run(workload=cell, config=conf, mix=mix,
                       limits=bench.limits(cell), seed=seed, seconds=0.0,
                       trace=False, device="cuda", started=time.time())


@pytest.mark.card
@pytest.mark.parametrize("cell", ["dsv2lite-train-4k", "stablelm3b-train-4k"])
def test_the_control_reads_further_off_than_the_program(cell):
    card_or_skip()
    from portbench.reference import model
    for seed in SEEDS:
        ctx = context(cell, seed)
        ref, _ = calibrate.reference_readings(ctx)
        mine, _ = calibrate.program_readings(ctx)
        ctl, _ = calibrate.reference_readings(ctx, model.fp8_mm)
        program = calibrate.reading("program", seed, mine, ref, 0)
        control = calibrate.reading("control", seed, ctl, ref, 0)
        # the control fails one of the numbers by three times the
        # program's reading of it or more
        assert any(control["numbers"][k] >= 3 * program["numbers"][k]
                   for k in program["numbers"]), (program, control)
