"""Strategy Evaluator: every search strategy, one measurement budget.

Runs the full strategy roster — ppo / greedy-swap / random / beam x
{oracle, cost, policy} / greedy-lookahead — over registry kernels, each
cell on a **fresh** ``FastTimingBackend`` so its memo counters are that
cell's true measurement bill, and emits a per-kernel comparison table:
best cycles, improvement vs the -O3 baseline, real measurements spent,
wall time.

The harness owns the cost-model lifecycle the guided strategies need:

1. **warm** — one PPO run per kernel (this is also the roster's "ppo"
   row), harvesting the agent for the :class:`PolicyRanker` and the
   backend memo's measurement corpus;
2. **train** — export the warm memos into a :class:`CostDataset`, fit the
   :class:`CostModel`, and score its held-out Spearman rank correlation
   against the oracle cycles;
3. **race** — run every remaining strategy cell under the shared budget.

Budget semantics: ``budget`` is the per-cell real-measurement allowance.
PPO gets it as timesteps, greedy as ``budget / branching`` steps, random
as restart episodes; the beam/lookahead strategies enforce it directly
via ``max_measurements`` — the model-guided ones get only a **quarter of
what greedy actually spent** on that kernel (``budget / 4`` when greedy
is not in the roster), which is the claim under test
(ranked-then-verified search matches exhaustive probing on a fraction of
the measurements).

CLI: ``python -m repro_torch.launch.evaluate``.

Port of ``repro/costmodel/evaluator.py``.  ``evaluate_strategies``
takes ``device``, where the PPO warm phase's agent and the cost model
run (default: the card; it raises without one unless given a device);
the environments and their measurements stay on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.env import AssemblyGame
from repro_torch.core.microbench import build_stall_table
from repro_torch.core.ppo import Agent, PPOConfig
from repro_torch.costmodel.dataset import CostDataset, ProgramFeaturizer
from repro_torch.costmodel.model import CostModel
from repro_torch.costmodel.search import (BeamSearchStrategy,
                                          GreedyLookaheadStrategy)
from repro_torch.sched import baseline, lowering
from repro_torch.sched.backends import FastTimingBackend, SharedMeasureMemo
from repro_torch.sched.session import (GreedySwapStrategy, PPOStrategy,
                                       RandomSearchStrategy)
from repro_torch.utils.device import resolve_device

# the two kernels of §5.7 — the paper's discovery study set
DEFAULT_KERNELS = ("matmul_leakyrelu", "bmm")

DEFAULT_STRATEGIES = ("ppo", "greedy", "random", "beam-oracle",
                      "beam-cost", "beam-policy", "lookahead")

# strategies that rank through the trained cost model / policy value head
# run on a quarter of greedy's measured bill (or of the budget when greedy
# is absent) — the evaluator's headline comparison
GUIDED_BUDGET_DIVISOR = 4

# roster names whose cells race before the guided ones (greedy's measured
# spend sizes the guided allowance)
UNGUIDED = ("greedy", "random", "beam-oracle")


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks (scipy.stats.rankdata; the container has no
    scipy)."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    # average ranks over tied values
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson over average-tie ranks)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) < 2:
        return float("nan")
    ra, rb = _rankdata(a), _rankdata(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0 or sb == 0:
        return float("nan")
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))


def heldout_rank_correlation(model: CostModel, dataset: CostDataset,
                             min_group: int = 3) -> float:
    """Size-weighted mean per-kernel Spearman of model predictions vs
    measured cycles over the held-out split."""
    ev = dataset.eval
    if len(ev) == 0:
        return float("nan")
    pred = model.predict_log(ev.X)
    corrs, weights = [], []
    for g in np.unique(ev.group):
        m = ev.group == g
        if int(m.sum()) < min_group:
            continue
        c = spearman(pred[m], ev.y[m])
        if not np.isnan(c):
            corrs.append(c)
            weights.append(int(m.sum()))
    if not corrs:
        return float("nan")
    return float(np.average(corrs, weights=weights))


def _baseline_branching(program, stall_db) -> int:
    """Legal-swap count of the -O3 schedule — the per-step probe bill a
    steepest-descent pass pays (sized on a throwaway env so nothing is
    charged to any strategy's backend)."""
    env = AssemblyGame(program, stall_db=stall_db, episode_length=1)
    return max(1, len(env.valid_actions()))


def make_roster(names: Sequence[str], budget: int, seed: int,
                branching: Dict[str, int], model: Optional[CostModel],
                policy_agents: Dict[str, Agent],
                guided_budget: Dict[str, int]) -> Dict[str, "callable"]:
    """name -> (kernel -> strategy instance) factories for the race phase
    (per-kernel because branching / policy agents / guided budgets are
    per-kernel).  ``guided_budget`` is looked up at *call* time so the
    race loop can re-derive it from greedy's measured spend before the
    guided cells run.

    Guided beams run at ``width=1``: verified first-improvement descent
    with model-ordered probing.  Wider beams expand predicted-but-
    unverified candidates whose children then compete for the scarce
    verification budget — empirically that drifts on the 1-cycle
    near-ties where the model misranks, while the width-1 walk matches
    greedy's best on a quarter of its measurements.
    """
    roster = {}
    for name in names:
        if name == "ppo":
            continue                       # the warm phase is the ppo row
        if name == "greedy":
            roster[name] = lambda k: GreedySwapStrategy(
                max_steps=max(1, budget // branching[k]))
        elif name == "random":
            roster[name] = lambda k: RandomSearchStrategy(
                episodes=max(1, budget // 16), episode_length=16, seed=seed)
        elif name == "beam-oracle":
            roster[name] = lambda k: BeamSearchStrategy(
                width=4, depth=64, ranker="oracle",
                max_measurements=budget)
        elif name == "beam-cost":
            roster[name] = lambda k: BeamSearchStrategy(
                width=1, depth=64, verify_top_k=2, ranker="cost",
                model=model, max_measurements=guided_budget[k])
        elif name == "beam-policy":
            roster[name] = lambda k: BeamSearchStrategy(
                width=1, depth=64, verify_top_k=2, ranker="policy",
                policy_agent=policy_agents[k],
                max_measurements=guided_budget[k])
        elif name == "lookahead":
            roster[name] = lambda k: GreedyLookaheadStrategy(
                lookahead=4, verify_top_k=2, max_steps=64, ranker="cost",
                model=model, max_measurements=guided_budget[k])
        else:
            raise KeyError(f"unknown evaluator strategy {name!r}; one of "
                           f"{list(DEFAULT_STRATEGIES)}")
    return roster


def evaluate_strategies(kernels: Optional[Sequence[str]] = None,
                        strategies: Optional[Sequence[str]] = None,
                        budget: int = 512,
                        seed: int = 0,
                        train_steps: int = 1500,
                        stall_db: Optional[Dict[str, int]] = None,
                        extra_memo: Optional[SharedMeasureMemo] = None,
                        verbose: bool = False, device=None) -> Dict:
    """Run the strategy roster under a shared per-cell measurement budget.

    Returns ``{"rows": [...], "rank_correlation": float, "budget": int,
    "dataset_rows": int, "model": CostModel | None}`` — rows carry
    (strategy, kernel, baseline/best cycles, improvement vs -O3, real
    measurements spent, wall seconds).  ``extra_memo`` contributes extra
    training corpus (e.g. a campaign's ``--memo-dir`` payload) without
    affecting any cell's accounting.  ``device`` is where the PPO warm
    phase's agent and the cost model run (default: the card).
    """
    device = resolve_device(device)
    kernels = list(kernels or DEFAULT_KERNELS)
    strategies = list(strategies or DEFAULT_STRATEGIES)
    if stall_db is None:
        stall_db = build_stall_table()

    from repro_torch.kernels import get_kernel
    programs: Dict[str, list] = {}
    for name in kernels:
        kdef = get_kernel(name)
        spec = kdef.make_spec(kdef.configs[0])
        programs[name] = baseline.schedule(lowering.lower(spec))
    featurizers = {name: ProgramFeaturizer(prog, stall_db=stall_db)
                   for name, prog in programs.items()}
    branching = {name: _baseline_branching(prog, stall_db)
                 for name, prog in programs.items()}

    rows: List[Dict] = []

    def add_row(strategy: str, kernel: str, outcome, spent: int,
                seconds: float) -> None:
        rows.append({
            "strategy": strategy, "kernel": kernel,
            "baseline_cycles": float(outcome.baseline_cycles),
            "best_cycles": float(outcome.best_cycles),
            "improvement_pct": round(
                100.0 * (outcome.baseline_cycles - outcome.best_cycles)
                / outcome.baseline_cycles, 3),
            "measurements": int(spent),
            "seconds": round(seconds, 3),
        })

    # -- phase 1: warm (the roster's "ppo" row + training corpus) ------------
    policy_agents: Dict[str, Agent] = {}
    datasets: List[CostDataset] = []
    needs_model = any(s in ("beam-cost", "lookahead") for s in strategies)
    needs_warm = needs_model or "ppo" in strategies \
        or "beam-policy" in strategies
    if needs_warm:
        ppo_cfg = PPOConfig(
            total_timesteps=budget, num_envs=4,
            num_steps=max(8, min(32, budget // 8)),
            episode_length=16, seed=seed)
        for name in kernels:
            backend = FastTimingBackend()
            t0 = time.time()
            outcome = PPOStrategy(ppo_cfg, device=device).search(
                programs[name], stall_db=stall_db, backend=backend,
                owner=name, verbose=verbose)
            spent = backend.memo.stats()["misses"]
            if "ppo" in strategies:
                add_row("ppo", name, outcome, spent, time.time() - t0)
            policy_agents[name] = outcome.game.agent
            datasets.append(CostDataset.from_memo(
                backend.memo, {name: programs[name]}, stall_db=stall_db,
                featurizers={name: featurizers[name]}))
            if verbose:
                print(f"[evaluator] warmed {name}: {spent} measurements, "
                      f"{len(datasets[-1])} dataset rows")
    if extra_memo is not None:
        datasets.append(CostDataset.from_memo(
            extra_memo, programs, stall_db=stall_db,
            featurizers=featurizers))

    # -- phase 2: train the cost model + held-out rank correlation -----------
    dataset = CostDataset.concat(datasets)
    model: Optional[CostModel] = None
    rank_corr = float("nan")
    if needs_model or (len(dataset) >= 2 and needs_warm):
        model, _ = CostModel.fit(dataset, steps=train_steps, seed=seed,
                                 device=device)
        rank_corr = heldout_rank_correlation(model, dataset)
        if verbose:
            print(f"[evaluator] cost model: {len(dataset)} rows, held-out "
                  f"Spearman {rank_corr:.3f}")

    # -- phase 3: the race ----------------------------------------------------
    # unguided cells go first: greedy's measured spend sizes the guided
    # allowance (spent // 4), so "a quarter of greedy's bill" is exact
    # per kernel rather than a share of the nominal budget
    guided_budget = {k: max(1, budget // GUIDED_BUDGET_DIVISOR)
                     for k in kernels}
    roster = make_roster(strategies, budget, seed, branching, model,
                         policy_agents, guided_budget)
    order = sorted(roster, key=lambda s: (s not in UNGUIDED, s != "greedy"))
    for sname in order:
        for kernel in kernels:
            backend = FastTimingBackend()
            strategy = roster[sname](kernel)
            t0 = time.time()
            outcome = strategy.search(programs[kernel], stall_db=stall_db,
                                      backend=backend, owner=kernel,
                                      verbose=verbose)
            spent = backend.memo.stats()["misses"]
            add_row(sname, kernel, outcome, spent, time.time() - t0)
            if sname == "greedy":
                guided_budget[kernel] = max(
                    1, spent // GUIDED_BUDGET_DIVISOR)

    return {"rows": rows, "rank_correlation": rank_corr,
            "budget": int(budget), "dataset_rows": len(dataset),
            "dataset": dataset, "model": model}


def format_table(result: Dict) -> str:
    """The per-kernel comparison table, human-readable."""
    rows = result["rows"]
    header = (f"{'strategy':<14} {'kernel':<18} {'baseline':>9} "
              f"{'best':>9} {'impr%':>7} {'meas':>6} {'sec':>7}")
    lines = [header, "-" * len(header)]
    for r in sorted(rows, key=lambda r: (r["kernel"], r["best_cycles"])):
        lines.append(
            f"{r['strategy']:<14} {r['kernel']:<18} "
            f"{r['baseline_cycles']:>9.0f} {r['best_cycles']:>9.0f} "
            f"{r['improvement_pct']:>7.2f} {r['measurements']:>6d} "
            f"{r['seconds']:>7.2f}")
    rc = result.get("rank_correlation")
    lines.append(f"cost-model held-out Spearman vs oracle: "
                 f"{rc if rc is None else round(rc, 3)} "
                 f"({result['dataset_rows']} corpus rows, "
                 f"budget {result['budget']}/cell)")
    return "\n".join(lines)
