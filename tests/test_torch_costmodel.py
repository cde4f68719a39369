"""The port's cost-model subsystem (``repro_torch.costmodel`` and
``repro_torch.launch.evaluate``) against the JAX package's on the CPU.

Deterministic parts must match exactly: the featurizer's vectors and
``CostDataset.from_memo``'s arrays (X, y, group, split) over one memo
warmed by the same greedy search in each package, the ``.npz`` files of
dataset and model crossing both ways, and the oracle-ranked ``beam`` and
``lookahead`` searches (best cycles, real measurements, listing).  Torch
cannot replay ``jax.random``, so the learned parts are held against the
reference by carrying parameters across:

- predictions: allclose at rtol 1e-6 (the reference's own save/load
  round trip) plus twice the reference's own f32 error against the
  port's f64 evaluation of the same parameters (ROADMAP §C's rule);
- 100 ``fit`` steps from the reference's initial parameters, on the
  same numpy batch indices: parameters allclose at atol 1e-6 (the PPO
  update's bound, ``tests/test_torch_ppo.py``: f32 sums in another
  order through Adam steps that move them by up to 0.09) and the loss
  history at rtol 1e-5;
- ``PolicyRanker``'s scores through ``agent_from_jax``: atol 1e-5, the
  bound of the agent's outputs in ``tests/test_torch_ppo.py``.

End to end the port's evaluator, at the reference acceptance test's
call (seed 0, on the CPU), meets the bounds the reference itself meets
there (Spearman >= 0.8, beam-cost within a quarter of greedy's
measurements).  Across seeds the Spearman clause is a coin in both
packages, and beam-cost against greedy's best fails in the reference
itself (ROADMAP §C).
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.analysis import analyze as janalyze
from repro.core.isa import program_text as jtext
from repro.costmodel import CostDataset as JDataset
from repro.costmodel import CostModel as JModel
from repro.costmodel import ProgramFeaturizer as JFeaturizer
from repro.costmodel.dataset import _split_of as jsplit_of
from repro.costmodel.rankers import PolicyRanker as JPolicyRanker
from repro.core import ppo as jppo
from repro.kernels import KERNELS as JKERNELS
from repro.sched import lower as jlower
from repro.sched import make_budgeted_strategy as jbudgeted
from repro.sched import schedule as jschedule
from repro.sched.backends import FastTimingBackend as JFast
from repro.sched.session import GreedySwapStrategy as JGreedy
from repro_torch.core.env import AssemblyGame
from repro_torch.core.isa import program_text as ttext
from repro_torch.core.ppo import agent_from_jax
from repro_torch.costmodel import (FEATURE_DIM, CostDataset, CostModel,
                                   CostModelVersionError, PolicyRanker,
                                   ProgramFeaturizer, evaluate_strategies)
from repro_torch.costmodel.dataset import _split_of
from repro_torch.kernels import KERNELS
from repro_torch.launch import evaluate as tevaluate
from repro_torch.sched import lower, make_budgeted_strategy, schedule
from repro_torch.sched.backends import FastTimingBackend
from repro_torch.sched.session import (STRATEGIES, GreedySwapStrategy,
                                       make_strategy)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
KERNEL = "matmul_leakyrelu"
PAIR = ("matmul_leakyrelu", "bmm")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny products: intra-op threads only contend (as in
    tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _programs(name):
    jk, tk = JKERNELS[name], KERNELS[name]
    return (jschedule(jlower(jk.make_spec(jk.configs[0]))),
            schedule(lower(tk.make_spec(tk.configs[0]))))


@pytest.fixture(scope="module")
def warm(stall_db):
    """Each package's memo after the same 8-step greedy search on
    matmul_leakyrelu, and the dataset each exports from it."""
    jprog, tprog = _programs(KERNEL)
    jb, tb = JFast(), FastTimingBackend()
    JGreedy(max_steps=8).search(jprog, stall_db=stall_db, backend=jb,
                                owner=KERNEL)
    GreedySwapStrategy(max_steps=8).search(tprog, stall_db=stall_db,
                                           backend=tb, owner=KERNEL)
    jds = JDataset.from_memo(jb.memo, {KERNEL: jprog}, stall_db=stall_db)
    tds = CostDataset.from_memo(tb.memo, {KERNEL: tprog}, stall_db=stall_db)
    return {"jprog": jprog, "tprog": tprog, "jmemo": jb.memo,
            "tmemo": tb.memo, "jds": jds, "tds": tds}


def _assert_same_dataset(a, b):
    for field in ("X", "y", "group", "split"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype, field
    assert a.feature_version == b.feature_version


# ---------------------------------------------------------------------------
# features, splits and datasets: bit-equal
# ---------------------------------------------------------------------------

def test_featurizer_vectors_match_reference(warm, stall_db):
    jfz = JFeaturizer(warm["jprog"], stall_db=stall_db)
    tfz = ProgramFeaturizer(warm["tprog"], stall_db=stall_db)
    env = AssemblyGame(warm["tprog"], stall_db=stall_db, episode_length=4)
    root = env.id_at.copy()
    orders = [root]
    for a in env.valid_actions():
        q = env.action_swap_pos(a)
        child = root.copy()
        child[q - 1], child[q] = child[q], child[q - 1]
        orders.append(child)
    orders.append(np.random.default_rng(0).permutation(len(root)))
    got, want = tfz.features_many(orders), jfz.features_many(orders)
    assert got.shape == (len(orders), FEATURE_DIM) and len(orders) > 3
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])        # order-sensitive


def test_dataset_from_memo_matches_reference(warm):
    """The two memos hold the same measurements, exported the same way;
    the datasets are bit-equal, splits included."""
    jds, tds = warm["jds"], warm["tds"]
    assert len(tds) > 20 and 0 < len(tds.eval) < len(tds)
    _assert_same_dataset(tds, jds)
    jentries = list(warm["jmemo"].export_entries())
    tentries = list(warm["tmemo"].export_entries())
    assert len(tentries) == len(jentries)
    for t, j in zip(tentries, jentries):
        if t.permutation is None:
            assert j.permutation is None
            continue
        for frac in (0.1, 0.25, 0.5):
            assert _split_of(t.records, t.permutation, frac) == \
                jsplit_of(j.records, j.permutation, frac)


def test_dataset_npz_crosses_both_ways(tmp_path, warm):
    jds, tds = warm["jds"], warm["tds"]
    assert tds.save(str(tmp_path / "t.npz")) == len(tds)
    jds.save(str(tmp_path / "j.npz"))
    _assert_same_dataset(JDataset.load(str(tmp_path / "t.npz")), jds)
    _assert_same_dataset(CostDataset.load(str(tmp_path / "j.npz")), tds)
    both = CostDataset.concat([tds, CostDataset.load(str(tmp_path /
                                                         "j.npz"))])
    _assert_same_dataset(both, JDataset.concat([jds, jds]))
    np.savez(str(tmp_path / "other.npz"), X=np.zeros((2, 3)))
    with open(tmp_path / "junk.npz", "wb") as f:
        f.write(b"not an npz payload")
    for bad in ("other.npz", "junk.npz"):
        with pytest.raises(CostModelVersionError):
            CostDataset.load(str(tmp_path / bad))
        with pytest.raises(CostModelVersionError):
            CostModel.load(str(tmp_path / bad), device="cpu")


# ---------------------------------------------------------------------------
# the MLP: predictions and fit from carried-across parameters
# ---------------------------------------------------------------------------

def _np_params(model):
    return {k: np.asarray(v) for k, v in model.params.items()}


def _f64_predict_log(params, norm, X):
    """The port's f64 evaluation of an MLP's log-cycle predictions."""
    xn = (np.asarray(X, np.float64) - norm["mu"]) / norm["sigma"]
    pred = CostModel.apply({k: torch.tensor(v, dtype=torch.float64)
                            for k, v in params.items()},
                           torch.from_numpy(xn)).numpy()
    return pred * float(norm["ystd"]) + float(norm["ymu"])


@pytest.fixture(scope="module")
def jmodel(warm):
    model, _ = JModel.fit(warm["jds"], steps=300, seed=0)
    return model


def test_predictions_match_reference(tmp_path, warm, jmodel):
    """The reference's trained parameters in the port, handed over in
    memory and through each package's ``.npz``."""
    X = warm["jds"].X
    want = np.asarray(jmodel.predict_log(X))
    exact = _f64_predict_log(_np_params(jmodel), jmodel.norm, X)
    ref_err = float(np.abs(want - exact).max())
    jmodel.save(str(tmp_path / "j.npz"))
    live = CostModel.from_numpy(_np_params(jmodel), jmodel.norm,
                                jmodel.feature_version, device="cpu")
    loaded = CostModel.load(str(tmp_path / "j.npz"), device="cpu")
    for model in (live, loaded):
        got = model.predict_log(X)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2 * ref_err)
    np.testing.assert_allclose(loaded.predict(X[:4]),
                               np.exp(loaded.predict_log(X[:4])))
    # and back: the port's file in the reference
    live.save(str(tmp_path / "t.npz"))
    back = JModel.load(str(tmp_path / "t.npz"))
    assert back.feature_version == live.feature_version
    np.testing.assert_array_equal(np.asarray(back.predict_log(X)), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_from_carried_parameters_matches_reference(warm, monkeypatch,
                                                       seed):
    """100 steps of ``fit`` from the reference's initial parameters: the
    same numpy batches, the same Adam with clipping, the same loss."""
    jds, tds = warm["jds"], warm["tds"]
    init = {k: np.asarray(v) for k, v in JModel.init(
        jax.random.PRNGKey(seed), jds.X.shape[1]).items()}
    monkeypatch.setattr(CostModel, "init", staticmethod(
        lambda gen, in_dim, hidden, device=None: {
            k: torch.tensor(v, device=device) for k, v in init.items()}))
    jm, jhist = JModel.fit(jds, steps=100, seed=seed)
    tm, thist = CostModel.fit(tds, steps=100, seed=seed, device="cpu")
    moved = 0.0
    for k, v in _np_params(jm).items():
        np.testing.assert_allclose(tm.params[k].numpy(), v, atol=1e-6,
                                   rtol=0, err_msg=k)
        moved = max(moved, float(np.abs(v - init[k]).max()))
    assert moved > 1e-2                               # the steps did move
    for k, v in jm.norm.items():
        np.testing.assert_array_equal(tm.norm[k], v)
    assert [r["step"] for r in thist] == [r["step"] for r in jhist]
    for t, j in zip(thist, jhist):
        for key in ("loss", "mse", "rank"):
            assert t[key] == pytest.approx(j[key], rel=1e-5), (key, t, j)


def test_fit_is_bit_reproducible(warm):
    m1, h1 = CostModel.fit(warm["tds"], steps=60, seed=3, device="cpu")
    m2, h2 = CostModel.fit(warm["tds"], steps=60, seed=3, device="cpu")
    for k in m1.params:
        assert torch.equal(m1.params[k], m2.params[k]), k
    assert h1 == h2
    m3, _ = CostModel.fit(warm["tds"], steps=60, seed=4, device="cpu")
    assert any(not torch.equal(m1.params[k], m3.params[k])
               for k in m1.params)
    with pytest.raises(ValueError, match="train rows"):
        CostModel.fit(warm["tds"]._subset(np.arange(len(warm["tds"])) < 1),
                      device="cpu")


def _recording(model, log):
    """``model`` with its ``predict_log`` recording every call's output."""
    real = model.predict_log

    def predict_log(X):
        out = np.asarray(real(X))
        log.append(out)
        return out
    model.predict_log = predict_log
    return model


def _first_flip(got, want):
    """(call, (i, j), port scores, reference scores) of the first ranker
    call whose stable argsort differs between the packages."""
    for call, (g, w) in enumerate(zip(got, want)):
        og, ow = np.argsort(g, kind="stable"), np.argsort(w, kind="stable")
        if not np.array_equal(og, ow):
            k = int(np.argmax(og != ow))
            i, j = int(og[k]), int(ow[k])
            return call, (i, j), (g[i], g[j]), (w[i], w[j])
    return None


@pytest.mark.parametrize("strategy", ["beam-cost", "lookahead"])
def test_cost_ranked_searches_match_reference(warm, jmodel, stall_db,
                                              strategy):
    """The evaluator's beam-cost cell (61 measurements, a quarter of
    greedy's bill on matmul_leakyrelu) and its lookahead cell cut to 16
    measurements, ranked by the reference's trained model carried
    across: the same walk.  A divergence names the first pair of
    candidates whose order flipped and their predicted log-cycles in
    each package."""
    from repro.costmodel.search import BeamSearchStrategy as JBeam
    from repro.costmodel.search import GreedyLookaheadStrategy as JLook
    from repro_torch.costmodel import (BeamSearchStrategy,
                                       GreedyLookaheadStrategy)
    kw = dict(verify_top_k=2, ranker="cost")
    if strategy == "beam-cost":
        kw.update(width=1, depth=64, max_measurements=61)
        classes = (BeamSearchStrategy, JBeam)
    else:
        kw.update(lookahead=4, max_steps=64, max_measurements=16)
        classes = (GreedyLookaheadStrategy, JLook)
    port = CostModel.from_numpy(_np_params(jmodel), jmodel.norm,
                                jmodel.feature_version, device="cpu")
    logs = ([], [])
    results = []
    for cls, model, log, prog, backend in (
            (classes[0], port, logs[0], warm["tprog"], FastTimingBackend()),
            (classes[1], JModel(jmodel.params, jmodel.norm), logs[1],
             warm["jprog"], JFast())):
        out = cls(model=_recording(model, log), **kw).search(
            prog, stall_db=stall_db, backend=backend, owner=KERNEL)
        results.append((out.best_cycles, backend.memo.stats()["misses"],
                        [s["best_cycles"] for s in out.stats]))
    assert results[0] == results[1], _first_flip(*logs)
    assert len(logs[0]) == len(logs[1]) > 3


# ---------------------------------------------------------------------------
# the policy ranker through the reference's agent parameters
# ---------------------------------------------------------------------------

def test_policy_ranker_scores_match_reference(warm, stall_db):
    """70 candidates: one full batch of 64 and one padded batch."""
    env = AssemblyGame(warm["tprog"], stall_db=stall_db, episode_length=4)
    rng = np.random.default_rng(0)
    orders = [rng.permutation(env.n) for _ in range(70)]
    params = {k: np.asarray(v) for k, v in jppo.init_agent(
        jax.random.PRNGKey(1), env.n, env.feature_dim,
        env.n - 1).items()}
    want = JPolicyRanker.from_game(params, warm["jprog"], janalyze(
        warm["jprog"], stall_db)).scores(orders)
    ranker = PolicyRanker.from_game(agent_from_jax(params, device="cpu"),
                                    warm["tprog"], env.analysis)
    got = ranker.scores(orders)
    assert got.dtype == np.float64 and got.shape == (70,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the oracle-ranked searches: identical to the reference
# ---------------------------------------------------------------------------

def _norm(text):
    """Listing text without the hash-derived LDV addresses and long SMOV
    immediates (tests/test_torch_sched.py)."""
    text = re.sub(r"(LDV R\d+, \[UR2\+)0x[0-9a-f]+\]", r"\1*]", text)
    return re.sub(r"(SMOV R\d+, )0x[0-9a-f]+", r"\1*", text)


@pytest.mark.parametrize("strategy", ["beam", "lookahead"])
def test_oracle_searches_match_reference(stall_db, strategy):
    """``--strategy beam|lookahead``'s strategies at the launcher's
    default budget: the same best cycles, real measurements and listing
    on both kernels of the pair."""
    got_cycles = {}
    for name in PAIR:
        jprog, tprog = _programs(name)
        outcomes = []
        for budgeted, backend, prog in (
                (make_budgeted_strategy, FastTimingBackend(), tprog),
                (jbudgeted, JFast(), jprog)):
            out = budgeted(strategy).search(prog, stall_db=stall_db,
                                            backend=backend, owner=name)
            outcomes.append((out, backend.memo.stats()))
        (tout, tstats), (jout, jstats) = outcomes
        assert (tout.baseline_cycles, tout.best_cycles) == \
            (jout.baseline_cycles, jout.best_cycles)
        assert tstats == jstats
        assert _norm(ttext(tout.best_program)) == \
            _norm(jtext(jout.best_program))
        assert [s["best_cycles"] for s in tout.stats] == \
            [s["best_cycles"] for s in jout.stats]
        got_cycles[name] = (tout.baseline_cycles, tout.best_cycles)
    want = {"beam": {"matmul_leakyrelu": (8294, 8286), "bmm": (8275, 8268)},
            "lookahead": {"matmul_leakyrelu": (8294, 8288),
                          "bmm": (8275, 8270)}}[strategy]
    assert got_cycles == want


def test_strategies_registry_resolves_lazily(stall_db):
    """``import repro_torch.sched`` does not load the cost model; the
    first build resolves the class and keeps it."""
    code = ("import sys, repro_torch.sched\n"
            "assert not any(m.startswith('repro_torch.costmodel') "
            "for m in sys.modules), 'costmodel loaded eagerly'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr
    beam = make_strategy("beam", width=2, depth=4, max_measurements=8)
    assert type(beam).__name__ == "BeamSearchStrategy"
    assert beam.name == "beam-oracle"
    la = make_strategy("lookahead", lookahead=2)
    assert type(la).__name__ == "GreedyLookaheadStrategy"
    assert la.name == "lookahead"
    assert not isinstance(STRATEGIES["beam"], str)
    with pytest.raises(ValueError, match="trained CostModel"):
        make_strategy("beam", ranker="cost").search(
            _programs("bmm")[1], stall_db=stall_db,
            backend=FastTimingBackend())


# ---------------------------------------------------------------------------
# the evaluator and its launcher
# ---------------------------------------------------------------------------

def test_evaluator_meets_the_reference_bounds():
    """The reference's acceptance call on the port, on the CPU: the bounds
    the reference itself meets (held-out Spearman >= 0.8; beam-cost
    spends more than nothing and at most a quarter of greedy's real
    measurements on each kernel)."""
    result = evaluate_strategies(strategies=("ppo", "greedy", "beam-cost"),
                                 budget=512, seed=0, device="cpu")
    assert result["rank_correlation"] >= 0.8, result["rank_correlation"]
    assert result["dataset_rows"] == len(result["dataset"]) > 500
    rows = {(r["strategy"], r["kernel"]): r for r in result["rows"]}
    assert set(rows) == {(s, k) for s in ("ppo", "greedy", "beam-cost")
                         for k in PAIR}
    for kernel in PAIR:
        greedy = rows[("greedy", kernel)]
        beam = rows[("beam-cost", kernel)]
        assert 0 < beam["measurements"] <= 0.25 * greedy["measurements"]
        for r in (greedy, beam, rows[("ppo", kernel)]):
            assert r["best_cycles"] <= r["baseline_cycles"]
    assert result["model"].device == torch.device("cpu")


def test_evaluate_launcher_needs_a_card_unless_asked(tmp_path, monkeypatch,
                                                     capsys):
    """Without a card the default device raises before any search; with
    ``--device cpu`` a small roster runs, writes the model and dataset
    files and a JSON with NaN as null."""
    calls = []
    real = tevaluate.evaluate_strategies

    def counting(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(tevaluate, "evaluate_strategies", counting)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(["--budget", "64", "--kernels", "bmm"])
    assert calls == []
    out = str(tmp_path / "ev.json")
    tevaluate.main(["--device", "cpu", "--budget", "64", "--kernels", "bmm",
                    "--strategies", "greedy,beam-oracle", "--out", out])
    text = capsys.readouterr().out
    assert "beam-oracle    bmm" in text and "Spearman vs oracle: nan" in text
    assert calls[0]["device"] == torch.device("cpu")
    with open(out) as f:
        payload = json.load(f)
    assert payload["rank_correlation"] is None and len(payload["rows"]) == 2
