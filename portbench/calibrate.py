"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed of ``--seeds`` the program runs the cell's first steps (the
driver's set-up, at the cell's sizes) and the float32 reference follows
them: the numbers of :mod:`portbench.check` are the program's lower
readings.  For each of ``--control-seeds`` the reference computed with
float8 products (:func:`portbench.reference.model.fp8_mm`) stands in the
program's place: the control's readings.  For each of ``--fault-seeds``
the program runs with half of each batch left out: that fault's
readings.  One JSON line a reading goes to standard output and to
``--out``.  The benchmark's runs do not run this; it needs a card.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.drivers import train  # noqa: E402
from portbench.reference import model, steps  # noqa: E402


def program_readings(ctx):
    prog = train.Program(ctx)
    t = time.perf_counter()
    mine = prog.first_steps(ctx.mix["setup_steps"])
    seconds = time.perf_counter() - t
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return mine, seconds


def reference_readings(ctx, mm=model.exact_mm):
    dtype = getattr(torch, train.port_config(ctx.config).dtype)
    t = time.perf_counter()
    out = steps.follow(ctx.config, ctx.mix, ctx.seed, ctx.device,
                       ctx.mix["setup_steps"], dtype, mm)
    seconds = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    return out, seconds


def reading(kind, seed, mine, ref, seconds):
    found = check.gaps(mine, ref)
    return {"kind": kind, "seed": seed, "seconds": seconds,
            "numbers": {k: v for k, (v, _) in found.items()},
            "worst": {k: w for k, (_, w) in found.items()},
            "losses": mine.losses, "reference_losses": ref.losses,
            "loss_gaps": check.loss_gaps(mine, ref)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness.Bench(ROOT)
    w = bench.workload(args.workload)
    base = dict(workload=w["name"], config=bench.config(w["config"]),
                mix=bench.mix(w["traffic"]), limits=bench.limits(w["name"]),
                seconds=0.0, trace=False, device="cuda",
                started=time.time())
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(dict(row, workload=w["name"]))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        ctx = harness.Run(seed=seed, **base)
        ref, ref_s = reference_readings(ctx)
        if seed in args.seeds:
            mine, s = program_readings(ctx)
            emit(reading("program", seed, mine, ref, s + ref_s))
        if seed in args.control_seeds:
            ctl, s = reference_readings(ctx, model.fp8_mm)
            emit(reading("control_fp8", seed, ctl, ref, s))
        if seed in args.fault_seeds:
            bad, s = program_readings(harness.Run(seed=seed, fault="half_batch",
                                                  **base))
            emit(reading("fault_half_batch", seed, bad, ref, s))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"peak_gib": peak,
                      "kind_of_card": torch.cuda.get_device_name(0)}),
          flush=True)


if __name__ == "__main__":
    main()
