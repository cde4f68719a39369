"""olmoe-1b-7b's training step with K1's narrow-row instances against the
same step with ``block_row`` for those calls, in one process.

    python3 tools/k1_narrow_step.py [--layers 8] [--steps 5] [--rounds 2]

On a machine with a CUDA card: olmoe-1b-7b at full width, ``--layers``
layers (``chip_smoke.py``'s training depth), bf16, seq 2048, batch 4,
one ``Trainer``'s train step called on batches of its data.  Two steps
warm up; then each round runs ``--steps`` steps on the narrow route
(``rmsnorm.select_tiling`` as shipped: the 128-wide q/k norms on
``lanes16_vec1``) and ``--steps`` on ``block_row`` (``NARROW_ROW_BYTES``
set to 0, so every call naming no br takes ``block_row``), in the order
narrow, block_row, block_row, narrow, ... .  A step's time is the host's
clock around the step and the read of its metrics (which waits for the
card).  Then one step of each route under torch.profiler: the summed
device time of its K1 kernels and of all its kernels (the card's busy
time; one stream, so kernels do not overlap).  Prints the card's name
and power limit, then one JSON line: each route's step times, their
median, K1's launches by tiling, the profiled step's wall, busy and K1
device milliseconds, and the medians' difference.  Imports no jax."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "olmoe-1b-7b"
SEQ, BATCH = 2048, 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("k1_narrow_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.train import TrainConfig, Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(ARCH).replace(n_layers=args.layers)
    n_steps = 4 + 2 * args.rounds * args.steps   # the profiled two too
    trainer = Trainer(cfg, TrainConfig(steps=n_steps, seq_len=SEQ,
                                       global_batch=BATCH), device="cuda")
    narrow_bytes = rms_mod.NARROW_ROW_BYTES
    step = 0

    def run(route, n):
        nonlocal step
        rms_mod.NARROW_ROW_BYTES = narrow_bytes if route == "narrow" else 0
        rms_mod.select_tiling.cache_clear()
        times = []
        for _ in range(n):
            batch = {k: torch.from_numpy(v).to("cuda")
                     for k, v in trainer.data.batch_at(step).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            {k: float(v) for k, v in metrics.items()}   # waits for the card
            times.append(time.perf_counter() - t0)
            step += 1
        return times

    run("narrow", 2)
    out = {r: {"step_s": [], "k1_tilings": {}} for r in ("narrow",
                                                        "block_row")}
    for i in range(args.rounds):
        order = ("narrow", "block_row") if i % 2 == 0 else ("block_row",
                                                           "narrow")
        for route in order:
            before = dict(rms_mod.launches_by_tiling)
            out[route]["step_s"] += run(route, args.steps)
            for t, n in rms_mod.launches_by_tiling.items():
                if n - before.get(t, 0):
                    out[route]["k1_tilings"][t] = (
                        out[route]["k1_tilings"].get(t, 0) + n
                        - before.get(t, 0))
    from torch.profiler import ProfilerActivity, profile
    for route in ("narrow", "block_row"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, = run(route, 1)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dur = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in kernels]
        out[route]["profiled_step"] = dict(
            wall_ms=1e3 * wall, busy_ms=sum(d for _, d in dur),
            k1_ms=sum(d for n, d in dur if "rmsnorm" in n),
            k1_kernels=sum(1 for n, _ in dur if "rmsnorm" in n))
    rms_mod.NARROW_ROW_BYTES = narrow_bytes
    rms_mod.select_tiling.cache_clear()
    for r in out.values():
        r["median_s"] = statistics.median(r["step_s"])
    print(json.dumps(dict(
        arch=ARCH, layers=args.layers, seq=SEQ, batch=BATCH,
        device=torch.cuda.get_device_name(0), routes=out,
        block_row_minus_narrow_ms=1e3 * (out["block_row"]["median_s"]
                                         - out["narrow"]["median_s"]))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
