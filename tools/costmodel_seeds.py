"""The cost model's acceptance numbers per seed, in either package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/costmodel_seeds.py \
        jax 0 12 [--sampler numpy]
    PYTHONPATH=src python tools/costmodel_seeds.py torch 0 12 \
        [--sampler numpy] [--device cuda]

Runs ``evaluate_strategies(("ppo", "greedy", "beam-cost"), budget=512)``
(``tests/test_costmodel.py::test_acceptance_spearman_and_guided_budget``'s
call) once per seed in [FIRST, LAST) and prints, per seed, the held-out
Spearman, the corpus rows, and for each kernel greedy's and beam-cost's
best cycles and real measurements, as one JSON object a line; the last
line holds the mean Spearman and how many seeds reach 0.8.

``--sampler own`` (the default) draws the PPO warm phase's actions as the
package does (``jax.random.categorical``, ``torch.multinomial``);
``--sampler numpy`` draws them in either package by Gumbel-max over the
package's own masked logits with noise from
``np.random.default_rng(1000 + seed)``: the same noise stream in both
packages, so the comparison is free of the two PRNGs.  The torch package
runs its agent and model on ``--device`` (default: the CPU, one thread).
"""

import argparse
import json

import numpy as np


def _numpy_sampler(package, rng):
    """A ``sample_action`` for ``core.game`` drawing Gumbel-max actions
    over the agent's masked logits with noise from ``rng[0]``."""
    if package == "jax":
        from repro.core.ppo import masked_log_probs, masked_logits
        from repro.core.ppo import policy_value

        def sample_action(params, key, state, mask):
            logits, value = policy_value(params, state)
            ml = np.asarray(masked_logits(logits, mask), np.float64)
            action = np.argmax(ml - np.log(-np.log(rng[0].random(ml.shape))),
                               axis=-1)
            lp = np.asarray(masked_log_probs(logits, mask))
            return action, lp[np.arange(len(action)), action], value
        return sample_action

    import torch
    from repro_torch.core.ppo import masked_log_probs, masked_logits

    @torch.no_grad()
    def sample_action(agent, gen, state, mask):
        logits, value = agent(state)
        ml = masked_logits(logits, mask).double().cpu().numpy()
        action = np.argmax(ml - np.log(-np.log(rng[0].random(ml.shape))),
                           axis=-1)
        action = torch.from_numpy(action).to(state.device)
        lp = masked_log_probs(logits, mask)
        return action, torch.gather(lp, 1, action[:, None])[:, 0], value
    return sample_action


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("first", type=int)
    ap.add_argument("last", type=int)
    ap.add_argument("--sampler", choices=("own", "numpy"), default="own")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    kw = {}
    if args.package == "jax":
        import repro.core.game as game
        from repro.costmodel import evaluate_strategies
    else:
        import torch

        import repro_torch.core.game as game
        from repro_torch.costmodel import evaluate_strategies
        if args.device == "cpu":
            torch.set_num_threads(1)   # tiny products: threads only contend
        kw["device"] = args.device
    rng = [None]
    if args.sampler == "numpy":
        game.sample_action = _numpy_sampler(args.package, rng)
    spearmans = []
    for seed in range(args.first, args.last):
        rng[0] = np.random.default_rng(1000 + seed)
        res = evaluate_strategies(strategies=("ppo", "greedy", "beam-cost"),
                                  budget=512, seed=seed, **kw)
        spearmans.append(res["rank_correlation"])
        row = {"package": args.package, "sampler": args.sampler,
               "seed": seed, "spearman": res["rank_correlation"],
               "rows": res["dataset_rows"]}
        for r in res["rows"]:
            if r["strategy"] in ("greedy", "beam-cost"):
                row[f"{r['strategy']} {r['kernel']}"] = (
                    r["best_cycles"], r["measurements"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"package": args.package, "sampler": args.sampler,
                      "seeds": [args.first, args.last],
                      "mean_spearman": float(np.mean(spearmans)),
                      "at_least_0.8": int(sum(s >= 0.8 for s in spearmans))}))


if __name__ == "__main__":
    main()
