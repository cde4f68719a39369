"""The port's serving slice against the JAX package, on the CPU.

The JAX model's initialised parameters are carried across with
``params_from_jax``; inputs come from numpy seeds and go to both
frameworks.  Checked: decode logits (dense and paged, scalar and ragged
positions) in f32 (see ``_assert_logits_close`` for the tolerance); the
port engine's streams (dense and paged) bit-exact against the port's
``generate()`` per request; those streams equal to the JAX engine's; the
paged engine's sharing / copy-on-write / spill counters equal to the JAX
engine's on a seeded Poisson trace; and the entry points' refusal to run
on the CPU unless asked."""

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

ARCHS = ["qwen1.5-4b", "gemma3-1b"]     # absolute caches; ring windows
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
    (a shared-prefix re-run) — the same inputs to both packages."""
    cfg, params, jcfg, jparams = _models(arch)
    cfg64, params64 = _f64(arch)
    B, bs, steps = 2, 4, 14
    nb = MAX_SEQ // bs
    rng = np.random.default_rng(2)
    table = rng.permutation(2 * nb).reshape(B, nb).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1))
    caches = init_paged_caches(cfg, 2 * nb, bs, B)
    caches64 = init_paged_caches(cfg64, 2 * nb, bs, B)
    jcaches = jax_init_paged_caches(jcfg, 2 * nb, bs, B)
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
    for c, jc in zip(caches, jcaches):      # the same pages were written
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


def test_paged_counters_match_jax_on_poisson_trace():
    """Shared system prompts (prefix hits, copy-on-write forks) and an
    oversubscribed pool (spill preemption) on a seeded trace: the port
    engine admits, shares, forks and spills exactly as the JAX engine,
    and produces the same streams."""
    cfg, params, jcfg, jparams = _models("qwen1.5-4b")
    # Prompts are a 10-token system prompt plus 0-2 tokens, so identical
    # prompts share their partial last block and fork it on first write.
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
    (streams, counters), (jstreams, jcounters) = results
    assert counters == jcounters
    assert streams == jstreams
    assert counters["prefix_hits"] > 0 and counters["cow_forks"] > 0 \
        and counters["preempt_spills"] > 0, counters


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
