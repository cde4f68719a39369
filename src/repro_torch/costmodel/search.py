"""Model-guided search strategies: beam search and greedy lookahead.

Both strategies explore the same masked-swap neighborhood as the PPO game
(children are single legal adjacent swaps, so every reached schedule is
reachable by masked swaps and therefore semantics-preserving), but rank
candidates through a :class:`~repro_torch.costmodel.rankers.CostRanker` and
route only the **top-k** through the session's real
:class:`~repro_torch.sched.backends.MeasureBackend` — the measurement path
(``ResilientBackend`` wrapping, shared-memo accounting,
``use_fast_measure`` fallback) composes unchanged because all measuring
still happens inside one :class:`~repro_torch.core.env.AssemblyGame` built
exactly like the other strategies build theirs.

The verified-cycles contract: ``SearchOutcome.best_cycles`` always comes
from a real measurement (``env.measure_schedule``), never from a model
prediction — an unverified candidate can win the *beam*, but it cannot
win the *search* without being measured.

``max_measurements`` bounds real measurements (memo misses / oracle runs)
spent by one search, so an evaluator can hand every strategy the same
budget and compare what each buys with it.

Port of ``repro/costmodel/search.py``: the same walks, so with the
oracle ranker both packages measure the same schedules in the same order
and reach the same cycles.  ``policy_agent`` is the port's
:class:`~repro_torch.core.ppo.Agent` where the reference takes
``policy_params``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.ppo import Agent
from repro_torch.costmodel.rankers import make_ranker
from repro_torch.sched.session import SearchOutcome, _strategy_env


def _spent(env) -> int:
    """Real measurements this env has paid for: fast-path memo misses plus
    oracle-path runs (oracle measurements never touch the memo counters)."""
    return env.measure_calls - env.memo_hits


def _expand(env, order: np.ndarray, seen: set) -> List[np.ndarray]:
    """All unseen single-masked-swap children of ``order``."""
    env.set_order(order)
    children = []
    for a in env.valid_actions():
        q = env.action_swap_pos(a)
        child = order.copy()
        child[q - 1], child[q] = child[q], child[q - 1]
        key = child.tobytes()
        if key not in seen:
            seen.add(key)
            children.append(child)
    return children


class BeamSearchStrategy:
    """Breadth-limited search over masked-swap space, ranked by a cost
    ranker: each depth expands every beam member's legal swaps, keeps the
    ``width`` best-scored candidates, and verifies the top
    ``verify_top_k`` on the real timer.  With ``ranker="oracle"`` every
    candidate is measured (classic beam search); with ``"cost"`` /
    ``"policy"`` thousands of candidates rank for the price of ``k``
    measurements per depth."""

    def __init__(self, width: int = 8, depth: int = 16,
                 verify_top_k: int = 2, ranker: str = "oracle",
                 model=None, policy_agent: Optional[Agent] = None,
                 max_measurements: Optional[int] = None):
        self.width = int(width)
        self.depth = int(depth)
        self.verify_top_k = int(verify_top_k)
        self.ranker = ranker
        self.model = model
        self.policy_agent = policy_agent
        self.max_measurements = max_measurements
        self.name = f"beam-{ranker}"

    def search(self, program, *, stall_db, backend, owner="", verbose=False):
        env = _strategy_env(program, stall_db, backend, owner,
                            episode_length=self.depth + 1)
        ranker = make_ranker(self.ranker, env, model=self.model,
                             policy_agent=self.policy_agent,
                             max_measurements=self.max_measurements)
        budget = self.max_measurements
        root = env.id_at.copy()
        beam: List[np.ndarray] = [root]
        best_order = root
        seen = {root.tobytes()}
        stats: List[Dict] = []
        for d in range(self.depth):
            if budget is not None and _spent(env) >= budget:
                break
            candidates: List[np.ndarray] = []
            for order in beam:
                candidates.extend(_expand(env, order, seen))
            if not candidates:
                break
            scores = ranker.scores(candidates)
            rank_idx = np.argsort(scores, kind="stable")
            improved = False
            if ranker.verified:
                # scores ARE measurements; env.best_* already tracked them
                # (a budget-capped oracle leaves inf for the unmeasured)
                i = int(rank_idx[0])
                if scores[i] <= env.best_cycles:
                    best_order = candidates[i]
                    improved = True
                measured = int(np.isfinite(scores).sum())
                beam = [candidates[int(i)] for i in rank_idx[:self.width]]
                if not any(np.array_equal(best_order, b) for b in beam):
                    beam.append(best_order)
            else:
                # verify in predicted order.  At least ``verify_top_k``
                # measurements (near-tie predictions need a real
                # comparison), escalating past k until one *improves* the
                # verified incumbent — misranked 1-cycle ties are exactly
                # where a fixed top-k verifies the wrong candidate and
                # drifts.
                measured = 0
                for i in rank_idx:
                    if budget is not None and _spent(env) >= budget:
                        break
                    if measured >= self.verify_top_k and improved:
                        break
                    prev_best = env.best_cycles
                    env.set_order(candidates[int(i)])
                    cycles = env.measure_schedule()
                    measured += 1
                    if cycles < prev_best:
                        best_order = candidates[int(i)]
                        improved = True
                # the verified incumbent anchors the beam (predictions
                # steer exploration, measurements steer the walk); the
                # remaining width-1 slots go to the best-scored candidates
                beam = [best_order]
                for i in rank_idx[:self.width - 1]:
                    c = candidates[int(i)]
                    if not np.array_equal(c, best_order):
                        beam.append(c)
            stats.append({"depth": d, "candidates": len(candidates),
                          "best_cycles": env.best_cycles,
                          "measurements": _spent(env),
                          "time": time.time()})
            if verbose:
                print(f"[{self.name}] depth={d} "
                      f"candidates={len(candidates)} "
                      f"best={env.best_cycles:.0f} spent={_spent(env)}")
            if measured >= len(candidates) and not improved:
                # a full verified sweep of the frontier found nothing
                # better: converged to a measured local optimum (the
                # greedy stopping rule, reached at a fraction of its bill)
                break
        return SearchOutcome(
            best_program=[ins.copy() for ins in env.best_program],
            best_cycles=env.best_cycles, baseline_cycles=env.t0,
            stats=stats)


class GreedyLookaheadStrategy:
    """Greedy descent with model-guided lookahead: from the current
    schedule, every legal swap is scored by the best ranker score found
    along a ``lookahead``-deep ranker-greedy rollout from it, the top
    ``verify_top_k`` children are verified for real, and the walk moves
    to the best-scored child.  A one-swap trap (a swap that scores worse
    now but enables a better schedule two swaps later) is exactly what
    the lookahead sees past and plain greedy does not."""

    def __init__(self, lookahead: int = 4, verify_top_k: int = 2,
                 max_steps: int = 32, ranker: str = "cost",
                 model=None, policy_agent: Optional[Agent] = None,
                 max_measurements: Optional[int] = None):
        self.lookahead = int(lookahead)
        self.verify_top_k = int(verify_top_k)
        self.max_steps = int(max_steps)
        self.ranker = ranker
        self.model = model
        self.policy_agent = policy_agent
        self.max_measurements = max_measurements
        self.name = f"lookahead-{ranker}" if ranker != "cost" else "lookahead"

    def search(self, program, *, stall_db, backend, owner="", verbose=False):
        env = _strategy_env(program, stall_db, backend, owner,
                            episode_length=self.max_steps + 1)
        ranker = make_ranker(self.ranker, env, model=self.model,
                             policy_agent=self.policy_agent,
                             max_measurements=self.max_measurements)
        budget = self.max_measurements
        current = env.id_at.copy()
        seen = {current.tobytes()}
        stats: List[Dict] = []
        for step in range(self.max_steps):
            if budget is not None and _spent(env) >= budget:
                break
            children = _expand(env, current, seen)
            if not children:
                break
            child_scores = ranker.scores(children)
            # rollout: follow the ranker greedily for lookahead - 1 more
            # swaps; a child is as good as the best score on its path
            rollout_seen = set(seen)
            for ci, child in enumerate(children):
                order, best_s = child, child_scores[ci]
                for _ in range(self.lookahead - 1):
                    nxt = _expand(env, order, rollout_seen)
                    if not nxt:
                        break
                    s = ranker.scores(nxt)
                    j = int(np.argmin(s))
                    best_s = min(best_s, s[j])
                    order = nxt[j]
                child_scores[ci] = best_s
            rank_idx = np.argsort(child_scores, kind="stable")
            if not ranker.verified:
                for i in rank_idx[:self.verify_top_k]:
                    if budget is not None and _spent(env) >= budget:
                        break
                    env.set_order(children[int(i)])
                    env.measure_schedule()
            current = children[int(rank_idx[0])]
            stats.append({"step": step, "candidates": len(children),
                          "best_cycles": env.best_cycles,
                          "measurements": _spent(env),
                          "time": time.time()})
            if verbose:
                print(f"[{self.name}] step={step} "
                      f"candidates={len(children)} "
                      f"best={env.best_cycles:.0f} spent={_spent(env)}")
        return SearchOutcome(
            best_program=[ins.copy() for ins in env.best_program],
            best_cycles=env.best_cycles, baseline_cycles=env.t0,
            stats=stats)
