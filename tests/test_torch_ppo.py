"""The port's PPO agent (``repro_torch.core.ppo``, ``core.game``,
``core.moves``, ``sched.api`` and the session's ``PPOStrategy``) against
the JAX package's on the CPU.

Torch cannot replay ``jax.random``, so the learned parts are held against
the reference by carrying parameters across (``agent_from_jax``) and by
feeding both updates the reference's own minibatch permutations:

- the network's logits and values, the masked log-probs and entropy, and
  ``compute_gae``: allclose in f32 (atol 1e-5 for the network's outputs,
  1e-6 for the rest);
- one whole update (2 epochs x 4 minibatches of Adam) from the same
  parameters on the same batch: the parameters allclose at atol 1e-6 (f32
  sums in another order, through 8 Adam steps that move them by more
  than 1e-4) and ``UpdateStats`` at rtol 1e-5;
- ``run_inference`` replays the identical greedy episode;
- ``train_on_program`` meets the bounds of ``tests/test_ppo.py::
  test_ppo_learns_on_kernel`` on the port's own ``rmsnorm`` listing
  (its learning signal over seeds, ROADMAP §C), and ``PPOStrategy`` ends
  at or below the ``-O3`` cycles of the §5.7 pair.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ppo as jppo
from repro.core.game import run_inference as jrun_inference
from repro.core.moves import lingering_fraction as jlingering
from repro.core.moves import top_moves as jtop_moves
from repro.kernels import KERNELS as JKERNELS
from repro.sched import lower as jlower
from repro.sched import schedule as jschedule
from repro_torch.core import ppo
from repro_torch.core.game import run_inference, train_on_program
from repro_torch.core.isa import program_text
from repro_torch.core.moves import lingering_fraction, top_moves
from repro_torch.kernels import KERNELS
from repro_torch.sched import (CuAsmRL, OptimizationSession, OptimizeRequest,
                               PPOStrategy, lower, make_budgeted_strategy,
                               schedule)

N_ROWS, FEAT, ACTIONS = 41, 12, 10      # 41 rows: SAME padding of an odd N


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _jparams(seed, n_rows=N_ROWS, feat=FEAT, actions=ACTIONS):
    p = jppo.init_agent(jax.random.PRNGKey(seed), n_rows, feat, actions)
    return {k: np.asarray(v) for k, v in p.items()}


def _mask(rng, b, a):
    m = (rng.random((b, a)) < 0.5).astype(np.float32)
    m[np.arange(b), rng.integers(0, a, b)] = 1.0        # one valid at least
    return m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_parameters_cross_both_ways():
    params = _jparams(0)
    agent = ppo.agent_from_jax(params)
    back = ppo.agent_to_jax(agent)
    assert sorted(back) == sorted(params)
    for k in params:
        assert back[k].shape == params[k].shape
        np.testing.assert_array_equal(back[k], params[k])


def test_init_agent_is_orthogonal_and_seeded():
    """The reference's initialisation: orthogonal blocks of the stated
    gains over the flattened (in, out) view, zero biases, drawn from the
    generator only."""
    a1 = ppo.init_agent(torch.Generator().manual_seed(3), N_ROWS, FEAT,
                        ACTIONS)
    a2 = ppo.init_agent(torch.Generator().manual_seed(3), N_ROWS, FEAT,
                        ACTIONS)
    p1, p2 = ppo.agent_to_jax(a1), ppo.agent_to_jax(a2)
    jp = _jparams(3)
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k])
        assert p1[k].shape == jp[k].shape
    for name, gain in (("conv1", 2 ** 0.5), ("conv2", 2 ** 0.5),
                       ("fc", 2 ** 0.5), ("actor", 0.01), ("critic", 1.0)):
        w = p1[f"{name}_w"].reshape(-1, p1[f"{name}_w"].shape[-1]) / gain
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)
        assert not p1[f"{name}_b"].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_value_matches_jax(seed):
    params = _jparams(seed)
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((16, N_ROWS, FEAT)).astype(np.float32)
    jl, jv = jppo.policy_value(params, state)
    tl, tv = ppo.agent_from_jax(params)(_t(state))
    assert tl.shape == (16, ACTIONS) and tv.shape == (16,)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-5, rtol=0)


def test_masked_log_probs_and_entropy_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((32, ACTIONS)) * 3).astype(np.float32)
    mask = _mask(rng, 32, ACTIONS)
    lp = ppo.masked_log_probs(_t(logits), _t(mask))
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jppo.masked_log_probs(logits, mask)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ppo.masked_entropy(_t(logits), _t(mask)).numpy(),
        np.asarray(jppo.masked_entropy(logits, mask)), atol=1e-6, rtol=0)
    # the reference's uniform-over-four bound (tests/test_ppo.py)
    ent = ppo.masked_entropy(torch.zeros(4, 8), torch.tensor(
        [[1.0] * 4 + [0.0] * 4] * 4))
    np.testing.assert_allclose(ent.numpy(), np.log(4.0), atol=1e-5)


def test_sampling_never_picks_a_masked_action():
    agent = ppo.agent_from_jax(_jparams(0, 40, 12, 10))
    gen = torch.Generator().manual_seed(0)
    state = torch.randn(16, 40, 12, generator=gen)
    mask = torch.zeros(16, 10)
    mask[:, [1, 4, 7]] = 1.0
    for _ in range(5):
        a, logp, v = ppo.sample_action(agent, gen, state, mask)
        assert set(a.tolist()) <= {1, 4, 7}
        assert torch.isfinite(logp).all() and torch.isfinite(v).all()
        want = ppo.masked_log_probs(agent(state)[0], mask).gather(
            1, a[:, None])[:, 0]
        assert torch.equal(logp, want)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 17, 5
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.15).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    adv, ret = ppo.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    jadv, jret = jppo.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    assert adv.dtype == np.float32 and adv.shape == (T, B)
    np.testing.assert_allclose(adv, np.asarray(jadv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ret, np.asarray(jret), atol=1e-6, rtol=0)


def test_lr_anneals_per_optimizer_step_as_the_reference():
    cfg = ppo.PPOConfig(total_timesteps=2048, num_envs=4, num_steps=64)
    total = cfg.num_updates * cfg.update_epochs * cfg.num_minibatches
    for step in (0, 1, 5, total - 1, total, total + 3):
        got = ppo._lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        want = jppo._lr_at(cfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert got.item() == pytest.approx(float(want), rel=1e-7, abs=0)
    flat = ppo.PPOConfig(anneal_lr=False)
    assert ppo._lr_at(flat, torch.tensor(7)).item() == pytest.approx(2.5e-4)


def _batch(params, rng, b):
    state = rng.standard_normal((b, N_ROWS, FEAT)).astype(np.float32)
    mask = _mask(rng, b, ACTIONS)
    action = np.array([rng.choice(np.flatnonzero(m)) for m in mask],
                      np.int32)
    logits, value = jppo.policy_value(params, state)
    lp = np.asarray(jppo.masked_log_probs(logits, mask))
    return {
        "state": state, "mask": mask, "action": action,
        # old log-probs off the current ones, so ratios leave the clip range
        "logprob": (lp[np.arange(b), action]
                    + rng.normal(0, 0.3, b)).astype(np.float32),
        "adv": rng.standard_normal(b).astype(np.float32),
        "ret": (np.asarray(value) + rng.normal(0, 1, b)).astype(np.float32),
        "value": (np.asarray(value) + rng.normal(0, 0.5, b)).astype(
            np.float32),
    }


def test_one_update_matches_jax():
    """One whole update from carried-across parameters, fed the
    reference's own permutations (``jax.random.permutation`` of the keys
    its update splits)."""
    cfg = ppo.PPOConfig(num_envs=4, num_steps=8, update_epochs=2,
                        num_minibatches=4, total_timesteps=64)
    params = _jparams(4)
    batch = _batch(params, np.random.default_rng(4), cfg.batch_size)
    key = jax.random.PRNGKey(9)
    jopt, jupdate = jppo.make_update_fn(cfg)
    jnew, _, jstats = jupdate(
        {k: jnp.asarray(v) for k, v in params.items()},
        jopt.init(params), batch, key)
    perms = np.stack([np.asarray(jax.random.permutation(ek, cfg.batch_size))
                      for ek in jax.random.split(key, cfg.update_epochs)])

    agent = ppo.agent_from_jax(params)
    opt, update = ppo.make_update_fn(cfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["action"] = tbatch["action"].long()
    state, stats = update(agent, opt.init(dict(agent.named_parameters())),
                          tbatch, _t(perms).long())
    assert int(state.step) == cfg.update_epochs * cfg.num_minibatches
    got = ppo.agent_to_jax(agent)
    moved = 0.0
    for k, v in jnew.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-6, rtol=0,
                                   err_msg=k)
        moved = max(moved, float(np.abs(np.asarray(v) - params[k]).max()))
    assert moved > 1e-4                      # the update did move them
    for name in jstats._fields:
        np.testing.assert_allclose(float(getattr(stats, name)),
                                   float(getattr(jstats, name)),
                                   atol=1e-7, rtol=1e-5, err_msg=name)
    assert 0 < float(stats.clip_frac) < 1    # both sides of the clip taken


def _norm(text):
    """Listing (or move window) text without the reference's hash-derived
    LDV addresses and long SMOV immediates (tests/test_torch_sched.py)."""
    text = re.sub(r"(LDV\s+R\d+, \[UR2\+)0x[0-9a-f]+\]", r"\1*]", text)
    return re.sub(r"(SMOV\s+R\d+, )0x[0-9a-f]+", r"\1*", text)


def test_run_inference_replays_the_identical_schedule(stall_db):
    """The greedy episode of carried-across parameters takes the same
    moves on the port's listing as on the reference's, and the moves
    module reads the same history."""
    jk, tk = JKERNELS["bmm"], KERNELS["bmm"]
    jprog = jschedule(jlower(jk.make_spec(jk.configs[0])))
    tprog = schedule(lower(tk.make_spec(tk.configs[0])))
    from repro.core import AssemblyGame as JGame
    probe = JGame(jprog, stall_db=stall_db)
    params = ppo.agent_to_jax(ppo.init_agent(
        torch.Generator().manual_seed(5), probe.n, probe.feature_dim,
        max(probe.num_actions, 2)))
    jenv = jrun_inference(jprog, {k: jnp.asarray(v)
                                  for k, v in params.items()},
                          stall_db=stall_db, episode_length=24)
    tenv = run_inference(tprog, ppo.agent_from_jax(params),
                         stall_db=stall_db, episode_length=24)
    steps = [(r.slot, r.direction, r.cycles_after) for r in tenv.history]
    assert steps == [(r.slot, r.direction, r.cycles_after)
                     for r in jenv.history]
    assert len(steps) >= 2
    from repro.core.isa import program_text as jtext
    assert _norm(program_text(tenv.best_program)) == \
        _norm(jtext(jenv.best_program))
    assert tenv.best_cycles == jenv.best_cycles
    assert lingering_fraction(tenv) == jlingering(jenv)
    mine, ref = top_moves(tenv, k=3), jtop_moves(jenv, k=3)
    assert [(m.step, m.kind, m.gain_pct) for m in mine] == \
        [(m.step, m.kind, m.gain_pct) for m in ref]
    assert [_norm(m.render()) for m in mine] == \
        [_norm(m.render()) for m in ref]


# Seeds whose learning signal is averaged: the reference's single-seed
# clause holds at 8 of seeds 0-11 for the reference itself (ROADMAP §C).
LEARN_SEEDS = (0, 1, 2, 3)


def test_ppo_learns_on_kernel(stall_db):
    """``tests/test_ppo.py::test_ppo_learns_on_kernel``'s config and bounds
    on the port's own ``rmsnorm`` listing; its last clause, the learning
    signal (the last update's episodic return at or above the first's),
    is held on the mean over ``LEARN_SEEDS`` (ROADMAP §C)."""
    k = KERNELS["rmsnorm"]
    program = schedule(lower(k.make_spec(k.configs[0])))
    gains = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # tiny convolutions: threads only contend
    try:
        for seed in LEARN_SEEDS:
            cfg = ppo.PPOConfig(total_timesteps=2048, num_envs=4, num_steps=64,
                                episode_length=48, seed=seed)
            res = train_on_program(program, stall_db=stall_db, cfg=cfg,
                                   device="cpu")
            assert res.best_cycles <= res.baseline_cycles
            assert res.improvement >= 0.0
            assert len(res.stats) == cfg.num_updates
            for row in res.stats:
                assert np.isfinite(row["approx_kl"])
                assert np.isfinite(row["entropy"])
                assert 0 <= row["agent_seconds"]
                assert 0 <= row["env_seconds"]
            gains.append(res.stats[-1]["episodic_return"]
                         - res.stats[0]["episodic_return"])
    finally:
        torch.set_num_threads(threads)
    assert np.mean(gains) >= 0.0, gains


def test_ppo_strategy_on_the_pair_ends_at_or_below_o3(tmp_path, stall_db):
    session = OptimizationSession(
        strategy=make_budgeted_strategy("ppo", timesteps=512,
                                        episode_length=16, device="cpu"),
        cache_dir=str(tmp_path), stall_db=stall_db, verify_seeds=2)
    results = session.optimize_many(["matmul_leakyrelu", "bmm"])
    o3 = {"matmul_leakyrelu": 8294, "bmm": 8275}
    for res in results:
        art = res.artifact
        assert res.strategy == "ppo" and res.game is not None
        assert art.baseline_cycles == o3[res.kernel]
        assert art.optimized_cycles <= art.baseline_cycles
        assert art.meta["ppo_updates"] == len(res.game.stats) >= 1
        assert res.game.agent.device.type == "cpu"
    assert session.deploy("bmm").optimized_cycles == \
        results[1].artifact.optimized_cycles


def test_request_ppo_config_keeps_the_strategy_device(tmp_path, stall_db):
    cfg = ppo.PPOConfig(total_timesteps=64, num_envs=2, num_steps=16,
                        episode_length=8, seed=1)
    session = OptimizationSession(strategy=PPOStrategy(device="cpu"),
                                  cache_dir=str(tmp_path), stall_db=stall_db,
                                  verify_seeds=2)
    res = session.optimize(OptimizeRequest(kernel="bmm", ppo=cfg))
    assert res.game.config is cfg and len(res.game.stats) == 2
    assert res.game.agent.device.type == "cpu"


def test_deprecated_shim_optimizes_and_deploys(tmp_path, stall_db):
    cfg = ppo.PPOConfig(total_timesteps=64, num_envs=2, num_steps=16,
                        episode_length=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = CuAsmRL(KERNELS["bmm"], ppo=cfg, cache_dir=str(tmp_path),
                       stall_db=stall_db, verify_seeds=2, device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    art = shim.optimize()
    assert shim.last_game is not None
    assert art.optimized_cycles <= art.baseline_cycles == 8275
    again = shim.deploy(str(tmp_path))
    assert again.optimized_cycles == art.optimized_cycles
    assert shim.deploy("bmm").optimized_cycles == art.optimized_cycles
