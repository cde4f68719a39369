"""Run one cell traced and print where its steps' device time went, by
the port's own spans (:mod:`portbench.spans`).

    python3 portbench/breakdown.py --workload <cell> --seed <n> \
        --seconds <s> [--trace 1]

Run from the root of a checkout, on the card.  It prints the run's
result line (as ``run.py --trace 1`` does), then one JSON line: device
ms a step by owning span (``null``: unspanned) and their sum against
the window's busy device time a step, the traced window's tokens a
second, the recompute's ms, the idle
gaps' seconds by the span the host was in, the device ms of the
largest (backward node, owner) pairs, the attribution's own seconds and
the run's.
"""

import json
import sys
import time

import run  # noqa: E402  (sets the caches and the import path)

from portbench import harness, spans  # noqa: E402

NODES = 30


def main(argv) -> int:
    args = harness.parse(argv)
    args.trace = 1
    import torch
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    bench = harness.Bench(run.ROOT)
    rec = harness.execute(bench, args, run.STARTED, "cuda")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": rec.peak_bytes}
    print(json.dumps(harness.result(bench, rec, info)), flush=True)
    s = spans.split(rec.trace)
    busy_ms = rec.trace.busy_s * 1e3 / s.steps
    ms = {str(k) if k is not None else "null": s.ms_per_step(k)
          for k in sorted(s.us, key=lambda k: -s.us[k])}
    t = time.perf_counter()
    idle = spans.idle_by_span(rec.trace)
    nodes = sorted(s.by_node.items(), key=lambda kv: -kv[1])[:NODES]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "steps": s.steps,
        "train_tokens_per_s": harness.reader("train_tokens_per_s")(rec),
        "ms_per_step": ms, "sum_ms": sum(ms.values()), "busy_ms": busy_ms,
        "recompute_ms": s.recompute_us / 1e3 / s.steps,
        "idle_s_by_span": {str(k): v for k, v in
                           sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_s": rec.trace.window_s - rec.trace.busy_s,
        "nodes_ms_per_step": [[n, o, us / 1e3 / s.steps]
                              for (n, o), us in nodes],
        "attribution_s": s.seconds,
        "idle_attribution_s": time.perf_counter() - t,
        "run_s": time.time() - run.STARTED}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
