"""Strategy Evaluator launcher: race every search strategy under one
measurement budget (the cost-model subsystem's comparison harness).

    PYTHONPATH=src python -m repro_torch.launch.evaluate \
        --kernels matmul_leakyrelu,bmm --budget 512 --out evaluator.json

    # reuse a campaign's measurement corpus and persist the trained
    # cost model + dataset next to it
    PYTHONPATH=src python -m repro_torch.launch.evaluate \
        --memo-dir runs/memo --train-cost-model

Sibling of ``launch.optimize``: where optimize runs *one* strategy per
campaign cell, evaluate runs the whole roster (ppo / greedy / random /
beam x {oracle, cost, policy} / lookahead) on fresh per-cell backends and
reports what each strategy's best cycles cost in real measurements.

Port of ``repro/launch/evaluate.py``, with the reference's flags and
files, and one more: ``--device``, where the PPO warm phase's agent and
the cost model run (default ``cuda``; with the default and no card the
launcher raises before any search).  ``--train-cost-model`` writes the
reference's dataset and model ``.npz`` formats, which either package
reads.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.costmodel.evaluator import (DEFAULT_KERNELS,
                                             DEFAULT_STRATEGIES,
                                             evaluate_strategies,
                                             format_table)
from repro_torch.launch.optimize import MEMO_FILENAME
from repro_torch.utils.device import resolve_device

DATASET_FILENAME = "cost_dataset.npz"
MODEL_FILENAME = "cost_model.npz"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategies", default=",".join(DEFAULT_STRATEGIES),
                    metavar="LIST",
                    help="comma-separated roster subset (default: "
                         + ",".join(DEFAULT_STRATEGIES) + ")")
    ap.add_argument("--kernels", default=",".join(DEFAULT_KERNELS),
                    metavar="LIST",
                    help="comma-separated registry kernel names "
                         "(default: the §5.7 pair)")
    ap.add_argument("--budget", type=int, default=512,
                    help="per-cell real-measurement allowance; "
                         "model-guided strategies get a quarter of "
                         "greedy's measured spend (budget/4 when greedy "
                         "is not in the roster)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=1500,
                    help="cost-model fit steps")
    ap.add_argument("--memo-dir", default=None,
                    help=f"read {MEMO_FILENAME} here as extra training "
                         "corpus; --train-cost-model writes the dataset "
                         "and model back alongside it")
    ap.add_argument("--train-cost-model", action="store_true",
                    help=f"persist {DATASET_FILENAME} + {MODEL_FILENAME} "
                         "into --memo-dir")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the machine-readable comparison here")
    ap.add_argument("--device", default=None,
                    help="torch device of the PPO agent and the cost model "
                         "(default: cuda; raises without one)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.train_cost_model and not args.memo_dir:
        ap.error("--train-cost-model needs --memo-dir to write into")
    # fail before any search, not inside the warm phase
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the reference computes the agent and the model in f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    extra_memo = None
    if args.memo_dir:
        from repro_torch.sched.backends import (SharedMeasureMemo,
                                                warm_start_memo)
        path = os.path.join(args.memo_dir, MEMO_FILENAME)
        if os.path.exists(path):
            extra_memo = SharedMeasureMemo()
            n = warm_start_memo(extra_memo, path)
            print(f"[evaluate] loaded {n} corpus entries from {path}")

    result = evaluate_strategies(
        kernels=[k for k in args.kernels.split(",") if k.strip()],
        strategies=[s for s in args.strategies.split(",") if s.strip()],
        budget=args.budget, seed=args.seed, train_steps=args.train_steps,
        extra_memo=extra_memo, verbose=args.verbose, device=device)

    print(format_table(result))

    if args.train_cost_model and result["model"] is not None:
        os.makedirs(args.memo_dir, exist_ok=True)
        ds_path = os.path.join(args.memo_dir, DATASET_FILENAME)
        model_path = os.path.join(args.memo_dir, MODEL_FILENAME)
        n = result["dataset"].save(ds_path)
        result["model"].save(model_path)
        print(f"[evaluate] saved {n}-row dataset to {ds_path}, "
              f"model to {model_path}")

    if args.out:
        payload = {k: v for k, v in result.items()
                   if k not in ("dataset", "model")}
        rc = payload.get("rank_correlation")
        if rc is not None and rc != rc:            # NaN -> null
            payload["rank_correlation"] = None
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2, allow_nan=False)
        print(f"[evaluate] wrote {args.out}")


if __name__ == "__main__":
    main()
