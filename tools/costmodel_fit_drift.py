"""How far two f32 fits of the cost model drift apart, one per package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/costmodel_fit_drift.py \
        DATASET.npz [--steps 100,1500] [--seeds 0,1]

Fits the reference's ``CostModel`` and the port's on the same dataset
(a ``repro-cost-dataset`` ``.npz``, e.g. ``launch.evaluate
--train-cost-model``'s ``cost_dataset.npz``) from the same initial
parameters (the reference's, carried into the port) on the same numpy
batches, on the CPU, and prints for each seed and step count the largest
parameter and prediction differences and each model's held-out Spearman:
what f32 summation order alone does to a fit.
"""

import argparse

import jax
import numpy as np
import torch


def main() -> None:
    from repro.costmodel import CostDataset as JDataset
    from repro.costmodel import CostModel as JModel
    from repro.costmodel.evaluator import heldout_rank_correlation as jrank
    from repro_torch.costmodel import CostDataset, CostModel
    from repro_torch.costmodel.evaluator import heldout_rank_correlation

    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--steps", default="100,1500")
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args()
    torch.set_num_threads(1)
    jds, tds = JDataset.load(args.dataset), CostDataset.load(args.dataset)
    real_init = CostModel.init
    try:
        for seed in map(int, args.seeds.split(",")):
            init = {k: np.asarray(v) for k, v in JModel.init(
                jax.random.PRNGKey(seed), jds.X.shape[1]).items()}
            CostModel.init = staticmethod(
                lambda gen, in_dim, hidden, device=None: {
                    k: torch.tensor(v, device=device)
                    for k, v in init.items()})
            for steps in map(int, args.steps.split(",")):
                jm, _ = JModel.fit(jds, steps=steps, seed=seed)
                tm, _ = CostModel.fit(tds, steps=steps, seed=seed,
                                      device="cpu")
                dp = max(float(np.abs(np.asarray(jm.params[k])
                                      - tm.params[k].numpy()).max())
                         for k in init)
                dy = float(np.abs(np.asarray(jm.predict_log(jds.X))
                                  - tm.predict_log(tds.X)).max())
                print(f"seed {seed} steps {steps}: parameters {dp:.3e}, "
                      f"predictions {dy:.3e}, held-out Spearman reference "
                      f"{jrank(jm, jds):.4f} port "
                      f"{heldout_rank_correlation(tm, tds):.4f}", flush=True)
    finally:
        CostModel.init = real_init


if __name__ == "__main__":
    main()
