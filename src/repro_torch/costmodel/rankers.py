"""Candidate rankers for model-guided search
(:mod:`repro_torch.costmodel.search`).

A :class:`CostRanker` scores candidate schedules — **lower is better** —
so a search strategy can triage thousands of candidates and route only
the top-k through the real measurement backend:

* :class:`OracleRanker` — scores *are* real measurements (every candidate
  goes through the game's timer + memo path).  ``verified = True``: the
  strategy may trust the scores as cycles.
* :class:`CostModelRanker` — predicted log-cycles from a trained
  :class:`~repro_torch.costmodel.model.CostModel` through the same
  :class:`~repro_torch.costmodel.dataset.ProgramFeaturizer` used at
  training time.  Predictions; never reported as cycles.
* :class:`PolicyRanker` — the PPO agent's value head
  (:func:`repro_torch.core.ppo.bootstrap_value`) over the schedule's
  embedding matrix: states the critic expects more future cycle
  reduction from score better.  Ranks *promise*, not absolute cycles.

Port of ``repro/costmodel/rankers.py``.  :class:`PolicyRanker` holds the
port's :class:`~repro_torch.core.ppo.Agent` (what ``GameResult.agent``
carries) where the reference holds a parameter dict, and scores on the
agent's device; the cost model scores on its own.  Candidates go in and
scores come out as numpy.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np

import torch

from repro_torch.core import embedding
from repro_torch.core.ppo import Agent, bootstrap_value
from repro_torch.costmodel.dataset import ProgramFeaturizer
from repro_torch.costmodel.model import CostModel

# PolicyRanker pads candidate batches to a multiple of this, as the
# reference does for its jitted critic: the critic sees batches of one
# shape, so the scores match the reference's batch for batch
_VALUE_BATCH = 64


@runtime_checkable
class CostRanker(Protocol):
    name: str
    verified: bool        # True iff scores are real measured cycles

    def scores(self, orders: Sequence[np.ndarray]) -> np.ndarray:
        """One score per candidate order; lower is better."""
        ...


class OracleRanker:
    """Every candidate measured for real through the game's measurement
    path (timer + shared memo, or the dataflow oracle) — the exhaustive
    reference the learned rankers are judged against.

    ``max_measurements`` stops mid-batch once the env's real-measurement
    spend reaches the cap; unmeasured candidates score ``inf`` so they
    rank last without pretending to be cycles.
    """

    name = "oracle"
    verified = True

    def __init__(self, env, max_measurements: Optional[int] = None):
        self._env = env
        self._budget = max_measurements

    def scores(self, orders: Sequence[np.ndarray]) -> np.ndarray:
        out = np.full(len(orders), np.inf, np.float64)
        env = self._env
        for i, order in enumerate(orders):
            if self._budget is not None and \
                    env.measure_calls - env.memo_hits >= self._budget:
                break
            env.set_order(order)
            out[i] = env.measure_schedule()
        return out


class CostModelRanker:
    """Predicted log-cycles from the trained MLP (monotonic in predicted
    cycles, so ranking is identical and the exp is skipped)."""

    name = "cost"
    verified = False

    def __init__(self, model: CostModel, featurizer: ProgramFeaturizer):
        if model.feature_version != featurizer.feature_version:
            raise ValueError(
                f"cost model trained on feature version "
                f"{model.feature_version}, featurizer computes "
                f"{featurizer.feature_version}")
        self._model = model
        self._featurizer = featurizer

    def scores(self, orders: Sequence[np.ndarray]) -> np.ndarray:
        X = self._featurizer.features_many(orders)
        return np.asarray(self._model.predict_log(X), np.float64)

    def predicted_cycles(self, orders: Sequence[np.ndarray]) -> np.ndarray:
        return np.exp(self.scores(orders))


class PolicyRanker:
    """PPO value head as a ranker: score = -V(s).  ``agent`` is the
    trained :class:`~repro_torch.core.ppo.Agent`; ``emb`` is the baseline
    program's embedding matrix (rows indexed by identity, the same
    ``embed_program`` output the game observes)."""

    name = "policy"
    verified = False

    def __init__(self, agent: Agent, emb: np.ndarray):
        self._agent = agent
        self._emb = np.asarray(emb, np.float32)

    @classmethod
    def from_game(cls, agent: Agent, program, analysis) -> "PolicyRanker":
        return cls(agent, embedding.embed_program(program, analysis))

    def scores(self, orders: Sequence[np.ndarray]) -> np.ndarray:
        states = np.stack([self._emb[np.asarray(o, np.int64)]
                           for o in orders])
        n = states.shape[0]
        pad = (-n) % _VALUE_BATCH
        if pad:
            states = np.concatenate(
                [states, np.repeat(states[-1:], pad, axis=0)])
        device = self._agent.device
        values = []
        for i in range(0, states.shape[0], _VALUE_BATCH):
            batch = torch.from_numpy(states[i:i + _VALUE_BATCH]).to(device)
            values.append(bootstrap_value(self._agent, batch).cpu().numpy())
        return -np.concatenate(values)[:n].astype(np.float64)


def make_ranker(name: str, env, *, model: Optional[CostModel] = None,
                featurizer: Optional[ProgramFeaturizer] = None,
                policy_agent: Optional[Agent] = None,
                max_measurements: Optional[int] = None) -> CostRanker:
    """Ranker factory the search strategies call at search time (rankers
    need the live env / featurizer, which only exist once ``search``
    runs)."""
    if name == "oracle":
        return OracleRanker(env, max_measurements=max_measurements)
    if name == "cost":
        if model is None:
            raise ValueError(
                "ranker='cost' needs a trained CostModel (train one via "
                "CostModel.fit on a CostDataset, or let the evaluator "
                "harness train it from a warmed memo)")
        if featurizer is None:
            featurizer = ProgramFeaturizer(env.original,
                                           analysis=env.analysis)
        return CostModelRanker(model, featurizer)
    if name == "policy":
        if policy_agent is None:
            raise ValueError(
                "ranker='policy' needs a PPO agent (GameResult.agent from "
                "a prior PPOStrategy run on this kernel)")
        return PolicyRanker(policy_agent,
                            embedding.embed_program(env.original,
                                                    env.analysis))
    raise KeyError(f"unknown ranker {name!r}; one of "
                   "['oracle', 'cost', 'policy']")
