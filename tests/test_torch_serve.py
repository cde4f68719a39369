"""The port's serving slice against the JAX package, on the CPU.

The JAX model's initialised parameters are carried across with
``params_from_jax``; inputs come from numpy seeds and go to both
frameworks.  Checked: decode logits (dense and paged, scalar and ragged
positions) in f32 (see ``_assert_logits_close`` for the tolerance) for
the dense (qwen1.5-4b, gemma3-1b), ssm (mamba2-1.3b) and hybrid
(zamba2-2.7b) families; the port engine's streams (dense and paged)
bit-exact against the port's ``generate()`` per request; those streams
equal to the JAX engine's; the paged engine's sharing / copy-on-write /
spill counters equal to the JAX engine's on a seeded Poisson trace;
spill preemption resuming recurrent slot rows and pages bit-exactly; and
the entry points' refusal to run on the CPU unless asked."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve.decode import decode_step as jax_decode_step
from repro.serve.decode import init_caches as jax_init_caches
from repro.serve.decode import init_paged_caches as jax_init_paged_caches
from repro.serve.decode import paged_decode_step as jax_paged_decode_step
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (ServeEngine, TrafficConfig, decode_step,
                               generate, init_caches, init_paged_caches,
                               paged_decode_step, poisson_trace)
from repro_torch.serve.decode import paged_cache_kinds

# absolute caches; ring windows; recurrent slot rows; both (zamba2)
ARCHS = ["qwen1.5-4b", "gemma3-1b", "mamba2-1.3b", "zamba2-2.7b"]
RECURRENT = ["mamba2-1.3b", "zamba2-2.7b"]
MAX_SEQ = 48
LOGIT_ATOL = 1e-4
SAME_FUNCTION_ATOL = 1e-3

_MODELS = {}


def _assert_logits_close(port, jax_logits, exact):
    """Port f32 logits against the JAX package's f32 logits.

    Both are f32 evaluations of one function that sum in other orders, so
    they may differ by the f32 rounding error of that function.  On the
    reduced gemma3-1b (embeddings scaled by sqrt(d), |logits| up to 30)
    that error alone exceeds 1e-4: the JAX package's own f32 logits lie up
    to 2.6e-4 from an f64 evaluation.  So the bound is atol 1e-4 plus
    twice the JAX package's own measured error against ``exact`` — the
    port's f64 evaluation on the same inputs — and ``exact`` must itself
    lie within 1e-3 of the JAX logits (the port in f64 computes the JAX
    package's function)."""
    jax_err = float(np.abs(np.asarray(jax_logits, np.float64) - exact).max())
    assert jax_err <= SAME_FUNCTION_ATOL, jax_err
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_logits),
                               atol=LOGIT_ATOL + 2 * jax_err, rtol=0)


def _f64(arch):
    """The port's f64 model on the JAX parameters (the exact evaluation)."""
    key = (arch, "f64")
    if key not in _MODELS:
        _, _, _, jparams = _models(arch)
        cfg = get_config(arch, reduced=True).replace(dtype="float64")
        _MODELS[key] = (cfg, params_from_jax(jax.tree.map(np.asarray,
                                                          jparams), cfg))
    return _MODELS[key]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _models(arch):
    """(port cfg, port params, JAX cfg, JAX params) — one JAX init each."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch, reduced=True)
        jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
        _MODELS[arch] = (cfg, params, jcfg, jparams)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# decode logits against the JAX decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch, ragged):
    cfg, params, jcfg, jparams = _models(arch)
    cfg64, params64 = _f64(arch)
    B, steps = 2, 14
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (steps, B, 1))
    caches = init_caches(cfg, B, MAX_SEQ)
    caches64 = init_caches(cfg64, B, MAX_SEQ)
    jcaches = jax_init_caches(jcfg, B, MAX_SEQ)
    for pos in range(steps):
        p = torch.full((B,), pos) if ragged else pos
        jp = jnp.full((B,), pos, jnp.int32) if ragged else pos
        tok = torch.from_numpy(toks[pos])
        logits, caches = decode_step(params, caches, tok, p, cfg)
        exact, caches64 = decode_step(params64, caches64, tok, p, cfg64)
        jlogits, jcaches = jax_decode_step(jparams, jcaches,
                                           jnp.asarray(toks[pos], jnp.int32),
                                           jp, jcfg)
        assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
        _assert_logits_close(logits, jlogits, exact.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_logits_match_jax(arch):
    """Ragged lanes (one starts 3 positions late), a scrambled physical
    block order, and a lane whose writes are masked for its first passes
    (a shared-prefix re-run) — the same inputs to both packages.  Slot
    entries (recurrent state) are passed gathered to the lanes' rows, as
    the engines pass them."""
    cfg, params, jcfg, jparams = _models(arch)
    cfg64, params64 = _f64(arch)
    B, bs, steps = 2, 4, 14
    nb = MAX_SEQ // bs
    rng = np.random.default_rng(2)
    table = rng.permutation(2 * nb).reshape(B, nb).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1))
    kinds = paged_cache_kinds(cfg)

    def lanes(caches, rows):
        return [{k: rows(a) for k, a in c.items()} if kind == "slot" else c
                for c, kind in zip(caches, kinds)]

    caches = lanes(init_paged_caches(cfg, 2 * nb, bs, B), lambda a: a[:B])
    caches64 = lanes(init_paged_caches(cfg64, 2 * nb, bs, B),
                     lambda a: a[:B])
    jcaches = lanes(jax_init_paged_caches(jcfg, 2 * nb, bs, B),
                    lambda a: a[:B])
    for t in range(steps):
        pos = np.array([t, max(0, t - 3)], np.int32)
        wmask = np.array([True, t >= 5])
        args = (torch.from_numpy(table), torch.from_numpy(toks[t]),
                torch.from_numpy(pos), torch.from_numpy(wmask))
        logits, caches = paged_decode_step(params, caches, *args, cfg,
                                           MAX_SEQ)
        exact, caches64 = paged_decode_step(params64, caches64, *args, cfg64,
                                            MAX_SEQ)
        jlogits, jcaches = jax_paged_decode_step(
            jparams, jcaches, jnp.asarray(table), jnp.asarray(toks[t],
                                                              jnp.int32),
            jnp.asarray(pos), jnp.asarray(wmask), jcfg, MAX_SEQ)
        _assert_logits_close(logits, jlogits, exact.numpy())
    for c, jc, kind in zip(caches, jcaches, kinds):
        if kind == "paged":                 # the same pages were written
            np.testing.assert_array_equal(c["k"].numpy() != 0,
                                          np.asarray(jc["k"]) != 0)


# ---------------------------------------------------------------------------
# engine streams: port generate() and the JAX engine
# ---------------------------------------------------------------------------

def _jobs(vocab):
    """The staggered jobs of tests/test_serve_engine.py."""
    rng = np.random.default_rng(0)
    jobs = []
    for _ in range(4):
        plen, n = int(rng.integers(3, 14)), int(rng.integers(2, 10))
        jobs.append((rng.integers(0, vocab, plen, dtype=np.int32).tolist(),
                     n))
    return jobs


def _drive(engine, jobs):
    reqs = [engine.submit(p, n) for p, n in jobs[:2]]
    for _ in range(3):                       # stagger: arrive mid-flight
        engine.step()
    reqs += [engine.submit(p, n) for p, n in jobs[2:]]
    engine.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_bitexact_vs_generate_and_jax(arch, paged):
    cfg, params, jcfg, jparams = _models(arch)
    kw = dict(max_batch=3, max_seq=MAX_SEQ, block_size=8, prefill_chunk=2,
              paged=paged)
    jobs = _jobs(cfg.vocab)
    engine = ServeEngine.from_config(cfg, params=params, device="cpu",
                                     debug_invariants=True, **kw)
    streams = _drive(engine, jobs)
    for out, (prompt, n) in zip(streams, jobs):
        ref = generate(params, cfg, np.asarray(prompt)[None], n,
                       max_seq=MAX_SEQ)[0, len(prompt):].tolist()
        assert out == ref, "engine stream diverged from port generate()"
        assert len(out) == n
    assert engine.pool.stats()["free_blocks"] == engine.pool.num_blocks
    jengine = jserve.ServeEngine.from_config(jcfg, params=jparams, **kw)
    assert streams == _drive(jengine, jobs), \
        "port engine streams differ from the JAX engine's"


def _counters_on_poisson_trace(arch):
    """Shared system prompts and an oversubscribed pool on a seeded
    trace, through the paged engines of both packages: (the port's
    streams and counters, the JAX engine's)."""
    cfg, params, jcfg, jparams = _models(arch)
    # Prompts are a 10-token system prompt plus 0-2 tokens, so identical
    # prompts share their partial last block and fork it on first write
    # (where the family shares prefixes: not ssm or hybrid).
    traffic = TrafficConfig(qps=100.0, n_requests=10, n_tenants=2,
                            prompt_len=(0, 2), output_len=(4, 16),
                            vocab=cfg.vocab, seed=1, prefix_tokens=10,
                            prefix_groups=2)
    trace = poisson_trace(traffic, ["t0", "t1"])
    kw = dict(max_batch=4, max_seq=MAX_SEQ, block_size=4, kv_blocks=16,
              paged=True, prefill_chunk=2)
    names = ("prefix_hits", "cow_forks", "preempt_spills", "resume_uploads",
             "passes", "admissions")
    results = []
    for eng in (ServeEngine.from_config(cfg, params=params, device="cpu",
                                        tenants=None, **kw),
                jserve.ServeEngine.from_config(jcfg, params=jparams, **kw)):
        reqs = [eng.submit(a.prompt, a.max_new_tokens) for a in trace]
        eng.run(max_steps=5000)
        results.append(([r.output for r in reqs],
                        {k: eng.counters[k] for k in names}))
    return results


def test_paged_counters_match_jax_on_poisson_trace():
    """Shared system prompts (prefix hits, copy-on-write forks) and an
    oversubscribed pool (spill preemption) on a seeded trace: the port
    engine admits, shares, forks and spills exactly as the JAX engine,
    and produces the same streams."""
    (streams, counters), (jstreams, jcounters) = \
        _counters_on_poisson_trace("qwen1.5-4b")
    assert counters == jcounters
    assert streams == jstreams
    assert counters["prefix_hits"] > 0 and counters["cow_forks"] > 0 \
        and counters["preempt_spills"] > 0, counters


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_paged_counters_match_jax_on_poisson_trace(arch):
    """The same trace on the ssm and hybrid families, which share no
    prefix (their recurrent rows are per request): equal counters and
    streams, spills and resumes included, and no prefix hit or fork."""
    (streams, counters), (jstreams, jcounters) = \
        _counters_on_poisson_trace(arch)
    assert counters == jcounters
    assert streams == jstreams
    assert counters["prefix_hits"] == counters["cow_forks"] == 0
    assert counters["preempt_spills"] > 0 \
        and counters["resume_uploads"] > 0, counters


@pytest.mark.parametrize("arch", RECURRENT)
def test_spill_preemption_resumes_slot_rows_bitexact(arch):
    """``tests/test_serve_paged.py::
    test_spill_preemption_resumes_bitexact_without_recompute`` on the
    port's recurrent families: with the pool oversubscribed, stalled
    victims spill their slot rows (and, for the hybrid, their pages) to
    the host and resume by uploading them into their new slot; streams
    stay bit-exact against the port's batched ``generate()`` and no
    request is teacher-force recomputed."""
    cfg, params, _, _ = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 12).tolist() for _ in range(3)]
    refs = generate(params, cfg, np.asarray(prompts), 20,
                    max_seq=MAX_SEQ).tolist()
    engine = ServeEngine.from_config(cfg, params=params, device="cpu",
                                     max_batch=4, max_seq=MAX_SEQ,
                                     block_size=8, kv_blocks=6, paged=True,
                                     share_prefix=False,
                                     debug_invariants=True)
    reqs = [engine.submit(p, 20) for p in prompts]
    engine.run(max_steps=5000)
    assert engine.counters["preempt_spills"] > 0, "pool never pressured"
    assert engine.counters["resume_uploads"] > 0
    for req, ref in zip(reqs, refs):
        assert list(req.prompt) + list(req.output) == ref
        assert not req.truncated
        assert not req.resume_tokens, "spill resume must not recompute"


# ---------------------------------------------------------------------------
# tuned schedules resolved by the engine (the schedule plan)
# ---------------------------------------------------------------------------

def _tuned_cache(pkg, d, stall_db):
    """A schedule cache written by one package: rmsnorm tuned at the
    default bucket and bmm at the fleet's first bucket (each dispatched
    to every bucket of the fleet, 6 of 18 cells); the other kernels
    untuned."""
    if pkg == "port":
        from repro_torch.configs import get_config as cfg_of
        from repro_torch.launch.specs import kernel_fleet
        from repro_torch.sched import (OptimizationSession, OptimizeRequest,
                                       make_budgeted_strategy)
    else:
        from repro.configs import get_config as cfg_of
        from repro.launch.specs import kernel_fleet
        from repro.sched import (OptimizationSession, OptimizeRequest,
                                 make_budgeted_strategy)
    scen = dict(kernel_fleet(cfg_of("qwen1.5-4b", reduced=True)))["bmm"]
    session = OptimizationSession(
        strategy=make_budgeted_strategy("greedy", timesteps=64,
                                        episode_length=8),
        cache_dir=d, stall_db=stall_db, verify_seeds=2)
    session.optimize(OptimizeRequest(kernel="rmsnorm"))
    session.optimize(OptimizeRequest(kernel="bmm", scenario=scen))
    return d


def _plan_lines(out):
    return [line for line in out.splitlines()
            if line.startswith(("[serve]   ", "[serve] WARNING",
                                "[serve] resolved", "[serve] schedule "))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_schedule_plan_matches_jax_over_either_packages_cache(
        tmp_path, stall_db, monkeypatch, capsys, writer):
    """Over a cache written by either package the port engine resolves
    the JAX engine's plan: the same ``plan_summary()`` lines (18 cells of
    qwen1.5-4b's fleet) and fallback count, and both refuse to start
    under ``on_missing="raise"``.  The serving launchers print the same
    plan lines and warning in engine and static modes, and
    ``--strict-schedules`` refuses before serving."""
    from repro.launch import serve as jlaunch_serve
    from repro.sched.cache import ScheduleCache as JCache
    from repro_torch.launch import serve as launch_serve
    from repro_torch.sched.cache import ScheduleCache
    d = _tuned_cache(writer, str(tmp_path / "cache"), stall_db)
    cfg, params, jcfg, jparams = _models("qwen1.5-4b")
    kw = dict(max_batch=2, max_seq=32)
    engine = ServeEngine.from_config(cfg, params=params, device="cpu",
                                     schedule_cache=d, **kw)
    jengine = jserve.ServeEngine.from_config(jcfg, params=jparams,
                                             schedule_cache=JCache(d), **kw)
    lines = engine.plan_summary()
    assert lines == jengine.plan_summary()
    assert len(lines) == 18 and isinstance(engine.schedule_cache,
                                           ScheduleCache)
    assert engine.counters["schedule_fallbacks"] == \
        jengine.counters["schedule_fallbacks"] == 12
    assert sum("not optimized (-O3 baseline)" in x for x in lines) == 12
    assert engine.plan[("rmsnorm", "b32_s32768_f32_full")] is not None
    for make in (lambda: ServeEngine.from_config(
            cfg, params=params, device="cpu", schedule_cache=d,
            on_missing="raise", **kw),
            lambda: jserve.ServeEngine.from_config(
                jcfg, params=jparams, schedule_cache=d, on_missing="raise",
                **kw)):
        with pytest.raises(FileNotFoundError, match="on_missing='raise'"):
            make()

    def launch(module, argv):
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        module.main()
        return _plan_lines(capsys.readouterr().out)

    common = ["--arch", "qwen1.5-4b", "--schedule-cache", d,
              "--prompt-len", "4", "--new-tokens", "2"]
    for mode in (["--qps", "50", "--requests", "2"], ["--batch", "1"]):
        got = launch(launch_serve, common + mode + ["--device", "cpu"])
        assert got == launch(jlaunch_serve, common + mode)
        assert len([x for x in got if "@b" in x]) == 18
    assert "[serve] schedule matmul_leakyrelu@b256_s4096_f32_full: not " \
        "optimized (-O3 baseline)" in got
    assert not any(x.startswith("[serve] schedule rmsnorm@") and
                   "not optimized" in x for x in got)
    monkeypatch.setattr(launch_serve, "run_load", lambda *a: 1 / 0)
    with pytest.raises(FileNotFoundError):
        launch(launch_serve, common + ["--qps", "50", "--device", "cpu",
                                       "--strict-schedules"])


def test_serve_hot_path_zero_measurements(tmp_path, stall_db, monkeypatch):
    """The port's counterpart of tests/test_serve_engine.py::
    test_serve_hot_path_zero_measurements: an engine constructed with a
    schedule cache resolves its whole kernel plan and serves traffic with
    zero ``Machine.run``/``Machine.time``/autotune calls."""
    from repro_torch.core import Machine
    from repro_torch.sched import OptimizationSession, make_budgeted_strategy
    from repro_torch.sched.cache import ScheduleCache
    from repro_torch.sched.session import OptimizeRequest

    session = OptimizationSession(
        strategy=make_budgeted_strategy("greedy", timesteps=64,
                                        episode_length=8),
        cache_dir=str(tmp_path / "cache"), stall_db=stall_db,
        verify_seeds=2)
    session.optimize(OptimizeRequest(kernel="rmsnorm"))

    calls = {"run": 0, "time": 0, "autotune": 0}
    real_run, real_time = Machine.run, Machine.time
    autotune_mod = sys.modules["repro_torch.sched.autotune"]

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(Machine, "run", counting("run", real_run))
    monkeypatch.setattr(Machine, "time", counting("time", real_time))
    monkeypatch.setattr(autotune_mod, "autotune",
                        counting("autotune", autotune_mod.autotune))

    cfg, params, _, _ = _models("qwen1.5-4b")
    engine = ServeEngine.from_config(
        cfg, params=params, max_batch=2, max_seq=32, device="cpu",
        schedule_cache=ScheduleCache(str(tmp_path / "cache")))
    rms = {k: v for k, v in engine.plan.items()
           if (k[0] if isinstance(k, tuple) else k) == "rmsnorm"}
    assert rms and all(a is not None for a in rms.values())
    assert any(a is None for a in engine.plan.values())
    reqs = [engine.submit([1, 2, 3, 4], 4), engine.submit([5, 6], 3)]
    engine.run()
    assert [len(r.output) for r in reqs] == [4, 3]
    assert calls == {"run": 0, "time": 0, "autotune": 0}


# ---------------------------------------------------------------------------
# entry points run on the card unless asked otherwise
# ---------------------------------------------------------------------------

def test_default_device_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params, _, _ = _models("qwen1.5-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params=params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen1.5-4b", "--qps", "10"])


def test_params_from_jax_checks_the_tree():
    cfg, _, _, jparams = _models("qwen1.5-4b")
    tree = jax.tree.map(np.asarray, jparams)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_jax(tree, cfg)
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["ln1"]
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tree, cfg)
