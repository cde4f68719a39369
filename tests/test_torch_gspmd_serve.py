"""Serving with a mesh: ``generate(mesh=)``, ``decode_step(mesh=)`` and
``ServeEngine(mesh=)`` of the port over 4 gloo ranks
(``tests/torch_gspmd_ranks.py::serve_runs``, one world for both
meshes), held against the reference's own serving on the same meshes
(``tests/gspmd_reference.py::start_serve_reference``: ``AxisType.Auto``
axes under ``jax.set_mesh``) and against the port's mesh-less serving.

Reduced qwen1.5-4b (GQA: KV heads on ``model``), gemma3-1b (one KV
head: the sequence on ``model``, its 8-position ring buffer 2 positions
a rank on (model 4), decoded past its window), olmoe-1b-7b (experts on
``model``, ``apply_moe_ep_replicated`` at one token a lane),
deepseek-v2-lite-16b (MLA: the latent on the sequence), mamba2-1.3b
(state heads and conv channels on ``model``), zamba2-2.7b (both) and
whisper-large-v3 (``generate`` and ``decode_step`` only: the engine
refuses it), on (data 2, model 2) and (model 4).  The engine's 5 slot
rows do not divide over ``data``, so on (data 2, model 2) its KV caches
split their sequence over both axes; with ``max_batch`` 3 its 4 rows
divide over ``data`` (``ROWS_ON_DATA``)."""

import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch

import gspmd_reference as gref
import torch_gspmd_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine, decode_step, generate
from repro_torch.serve.decode import init_caches

# chip_smoke.py's ``per_layer_fan_in``, one copy for the card and the tests
_smoke_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_smoke_spec)
_smoke_spec.loader.exec_module(smoke)

# one world runs every case of both meshes: 70-90 s alone (the
# reference's subprocesses about 80 s beside it), and the whole fixture
# took 606-655 s under the suite's 6 workers
RANK_DEADLINE_S = 900
ARCHS = ["qwen1.5-4b", "gemma3-1b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
         "mamba2-1.3b", "zamba2-2.7b", "whisper-large-v3"]
ENGINE_ARCHS = ARCHS[:-1]
MESHES = {"data2_model2": dict(model=2), "model4": dict(model=4)}
ENGINE = dict(max_batch=4, max_seq=48, block_size=8, prefill_chunk=2)
# engines whose max_batch + 1 slot rows divide over data: KV heads on
# model (qwen), the sequence on model (gemma's one KV head), and the
# SSM state and conv rows beside pages (zamba2, paged)
ROWS_ON_DATA = {"mesh": "data2_model2", "engine": dict(ENGINE, max_batch=3),
                "cases": [("qwen1.5-4b", "slot"), ("gemma3-1b", "slot"),
                          ("zamba2-2.7b", "paged")]}
PASSES = 12
# the arch also decoded from the init's own draw
INIT_DRAW = "qwen1.5-4b"
# ROADMAP §C: twice the reference's error for the dense families, the
# moe rule's GEMM_FACTOR for moe and MLA
FACTOR = {"olmoe-1b-7b": 3, "deepseek-v2-lite-16b": 3}
LOGIT_ATOL = 1e-4
SAME_FUNCTION_ATOL = 1e-3


def _spec():
    """Every input, drawn from one seed: 4 prompts of 8 tokens (8 new,
    caches of 32), 12 passes of 4 tokens, 5 engine jobs an arch."""
    rng = np.random.default_rng(0)
    spec = {"meshes": MESHES, "archs": ARCHS, "engine": ENGINE,
            "rows_on_data": ROWS_ON_DATA,
            "generate": {"new": 8, "max_seq": 32, "prompts": {}},
            "logits": {"tokens": {}}, "jobs": {}}
    for a in ARCHS:
        v = get_config(a, reduced=True).vocab
        spec["generate"]["prompts"][a] = rng.integers(0, v, (4, 8)).tolist()
        spec["logits"]["tokens"][a] = rng.integers(
            0, v, (PASSES, 4, 1)).tolist()
        spec["jobs"][a] = [(rng.integers(0, v, int(rng.integers(3, 14)))
                            .tolist(), int(rng.integers(2, 10)))
                           for _ in range(5)]
    return spec


def _jax_params(arch, per_layer=True):
    """The reference's PRNGKey(0) draw, by default with every stacked
    layer matrix at its own fan-in (``per_layer_fan_in``), as the
    encoder-decoder's tests and chip_smoke.py's parity phases draw: as
    drawn, the reduced models' 2-6 layers take the layer count as fan-in
    (``test_decode_logits_at_the_inits_draw``, ROADMAP §C)."""
    jcfg = jax_get_config(arch, reduced=True)
    model = jencdec if jcfg.family == "encdec" else jlm
    params = jax.tree.map(np.asarray,
                          model.init_model(jcfg, jax.random.PRNGKey(0)))
    return smoke.per_layer_fan_in(params) if per_layer else params


def _exact_logits(arch, jparams, steps, max_seq):
    """The port's mesh-less f64 decode logits over ``steps``: the
    yardstick of f32 rounding."""
    cfg64 = get_config(arch, reduced=True).replace(dtype="float64")
    p64 = params_from_jax(jparams, cfg64)
    caches = init_caches(cfg64, len(steps[0]), max_seq)
    out = []
    for i, tok in enumerate(steps):
        logits, caches = decode_step(p64, caches, torch.tensor(tok), i,
                                     cfg64)
        out.append(logits.numpy())
    return out


def _jax_meshless_logits(arch, jparams, steps, max_seq):
    """The reference's mesh-less f32 decode logits over ``steps``."""
    from repro.serve.decode import decode_step as jstep
    from repro.serve.decode import init_caches as jcaches
    jcfg = jax_get_config(arch, reduced=True)
    caches = jcaches(jcfg, len(steps[0]), max_seq)
    step = jax.jit(lambda p, c, t, pos: jstep(p, c, t, pos, jcfg))
    out = []
    for i, tok in enumerate(steps):
        logits, caches = step(jparams, caches,
                              np.asarray(tok, np.int32), np.int32(i))
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's serving (a subprocess a mesh) while the port's runs
    on 4 ranks, from the same parameters, then the port's mesh-less
    serving and its f64 decode logits (the yardstick)."""
    d = tmp_path_factory.mktemp("gspmd_serve")
    spec = _spec()
    jparams = {a: _jax_params(a) for a in ARCHS}
    jparams["init_draw"] = _jax_params(INIT_DRAW, per_layer=False)
    spec["params"] = {}
    for a, p in jparams.items():
        spec["params"][a] = str(d / f"params_{a}.npz")
        np.savez(spec["params"][a], **dict(ranks.flat(p)))
    spec["init_draw"] = {"arch": INIT_DRAW,
                         "params": spec["params"]["init_draw"]}
    reference = gref.start_serve_reference(d, spec)
    run_ranks(ranks.serve_runs, 4, str(d), spec,
              {a: dict(ranks.flat(p)) for a, p in jparams.items()},
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    ref = reference(timeout=RANK_DEADLINE_S)
    port = [torch.load(d / f"serve_{r}.pt", weights_only=False)
            for r in range(4)]
    meshless, exact = {}, {}
    max_seq = spec["generate"]["max_seq"]
    init_steps = spec["logits"]["tokens"][INIT_DRAW]
    exact["init_draw"] = _exact_logits(INIT_DRAW, jparams["init_draw"],
                                       init_steps, max_seq)
    meshless["init_draw"] = _jax_meshless_logits(
        INIT_DRAW, jparams["init_draw"], init_steps, max_seq)
    for a in ARCHS:
        cfg = get_config(a, reduced=True)
        params = params_from_jax(jparams[a], cfg)
        exact[a] = _exact_logits(a, jparams[a], spec["logits"]["tokens"][a],
                                 max_seq)
        if a not in ENGINE_ARCHS:
            continue
        for mode in ("slot", "paged"):
            engine = ServeEngine(cfg, params=params, device="cpu",
                                 paged=mode == "paged", **ENGINE)
            meshless[(a, mode)] = ranks.drive(engine, spec["jobs"][a])
            meshless[(a, mode + "_pool_bytes")] = engine.kv_bytes_allocated()
    for a, mode in ROWS_ON_DATA["cases"]:
        cfg = get_config(a, reduced=True)
        engine = ServeEngine(cfg, params=params_from_jax(jparams[a], cfg),
                             device="cpu", paged=mode == "paged",
                             **ROWS_ON_DATA["engine"])
        meshless[(a, mode, "rows_on_data")] = ranks.drive(
            engine, spec["jobs"][a])
    for a, run in (("zamba2-2.7b", ranks.spill_run),
                   ("deepseek-v2-lite-16b", ranks.fork_run)):
        cfg = get_config(a, reduced=True)
        meshless[run.__name__] = run(cfg, params_from_jax(jparams[a], cfg),
                                     device="cpu")
    cfg = get_config("zamba2-2.7b", reduced=True)
    meshless["spill_run/rows_on_data"] = ranks.spill_run(
        cfg, params_from_jax(jparams["zamba2-2.7b"], cfg), device="cpu",
        max_batch=ROWS_ON_DATA["engine"]["max_batch"])
    return spec, ref, port, meshless, exact


CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_generate_matches_reference(runs, mesh, arch):
    """``generate(mesh=)``'s tokens equal the reference's
    ``generate(mesh=)`` on the same mesh, on every rank."""
    _, (arrays, _), port, _, _ = runs
    want = arrays[f"{mesh}/{arch}/tokens"]
    for r in range(4):
        np.testing.assert_array_equal(port[r][mesh][arch]["tokens"], want,
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_decode_logits_match_reference(runs, mesh, arch):
    """The logits of 12 passes of ``decode_step(mesh=)`` (gemma past its
    window) within atol 1e-4 plus ``FACTOR`` (2; 3 for moe and MLA)
    times the reference's error against the port's mesh-less f64 decode,
    which must lie within 1e-3 (the same function), and the same on
    every rank."""
    _, (arrays, _), port, _, exact = runs
    factor = FACTOR.get(arch, 2)
    for i in range(PASSES):
        want = arrays[f"{mesh}/{arch}/logits{i}"]
        jax_err = float(np.abs(want.astype(np.float64) - exact[arch][i])
                        .max())
        assert jax_err <= SAME_FUNCTION_ATOL, (i, jax_err)
        got = port[0][mesh][arch]["logits"][i]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_ATOL + factor * jax_err,
                                   err_msg=f"pass {i}")
        for r in range(1, 4):
            np.testing.assert_array_equal(port[r][mesh][arch]["logits"][i],
                                          got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_logits_at_the_inits_draw(runs, mesh):
    """Reduced qwen1.5-4b from the init's own draw (its stacked layer
    matrices at the layer count's fan-in): at each of 12 passes of
    ``decode_step(mesh=)`` the port's error against its f64 decode lies
    within atol 1e-4 plus twice the reference's largest error on the
    input over its three runs (both meshes and mesh-less), and every
    rank's logits are the same.  Near one-hot attention makes the late
    passes amplify any f32 rounding, so one run's error does not measure
    the input: at pass 11 the reference's runs lie 6.4e-5 to 2.0e-4 from
    f64, and the port's mesh-less decode 8.2e-5 to 4.0e-4 as its norms,
    rope or products alone are evaluated in f64 or not
    (``tools/decode_parity_witness.py``; ROADMAP §C)."""
    _, (arrays, _), port, meshless, exact = runs
    for i in range(PASSES):
        truth = exact["init_draw"][i]
        jax_err = max(float(np.abs(w.astype(np.float64) - truth).max())
                      for w in [arrays[f"{m}/init_draw/logits{i}"]
                                for m in MESHES] + [meshless["init_draw"][i]])
        assert jax_err <= SAME_FUNCTION_ATOL, (i, jax_err)
        got = port[0][mesh]["init_draw"][i]
        np.testing.assert_allclose(got, truth, rtol=0,
                                   atol=LOGIT_ATOL + 2 * jax_err,
                                   err_msg=f"pass {i}")
        for r in range(1, 4):
            np.testing.assert_array_equal(port[r][mesh]["init_draw"][i],
                                          got)


@pytest.mark.parametrize("mode", ["slot", "paged"])
@pytest.mark.parametrize("mesh,arch",
                         [(m, a) for m in MESHES for a in ENGINE_ARCHS])
def test_engine_streams_match_reference_and_meshless(runs, mesh, arch, mode):
    """``ServeEngine(mesh=)``'s streams (max_batch 4, max_seq 48, 5
    staggered requests) equal the reference engine's on the same mesh
    and the port's mesh-less engine's, on every rank."""
    _, (_, streams), port, meshless, _ = runs
    want = streams[f"{mesh}/{arch}/{mode}"]
    assert meshless[(arch, mode)] == want
    for r in range(4):
        assert port[r][mesh][arch][mode] == want, f"rank {r}"


@pytest.mark.parametrize("arch,mode", ROWS_ON_DATA["cases"])
def test_engine_rows_on_data_match_reference_and_meshless(runs, arch, mode):
    """``ServeEngine(mesh=)`` with ``max_batch`` 3 on (data 2, model 2):
    its 4 slot rows divide over ``data``, each rank holds 2 of them, and
    its streams equal the reference engine's on that mesh and the port's
    mesh-less engine's, on every rank (their blocks are held by
    :func:`test_cache_blocks_keep_their_shape`)."""
    _, (_, streams), port, meshless, _ = runs
    mesh = ROWS_ON_DATA["mesh"]
    want = streams[f"{mesh}/{arch}/{mode}/rows_on_data"]
    assert meshless[(arch, mode, "rows_on_data")] == want
    for r in range(4):
        assert port[r][mesh][arch][mode + "/rows_on_data"] == want, \
            f"rank {r}"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("run", ["spill_run", "fork_run"])
def test_spill_and_fork_match_meshless(runs, mesh, run):
    """A zamba2 run that spills and resumes its slot rows and pages, and
    a deepseek run whose identical prompts share and fork MLA pages:
    streams and counters equal the mesh-less engine's on every rank."""
    _, _, port, meshless, _ = runs
    streams, counters = meshless[run]
    key = "preempt_spills" if run == "spill_run" else "cow_forks"
    assert counters[key] > 0 and counters["resume_uploads" if run ==
                                          "spill_run" else "prefix_hits"] > 0
    for r in range(4):
        assert port[r][mesh][run] == (streams, counters), f"rank {r}"


def test_spill_with_rows_on_data_matches_meshless(runs):
    """The zamba2 spill run with 3 lanes on (data 2, model 2): a spilled
    request's SSM and conv rows come from the rank that holds its slot
    and go back to the one that holds its new slot; streams and counters
    equal the mesh-less engine's on every rank."""
    _, _, port, meshless, _ = runs
    streams, counters = meshless["spill_run/rows_on_data"]
    assert counters["preempt_spills"] > 0 and counters["resume_uploads"] > 0
    for r in range(4):
        assert port[r][ROWS_ON_DATA["mesh"]]["spill_run/rows_on_data"] == \
            (streams, counters), f"rank {r}"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_blocks_keep_their_shape(runs, mesh):
    """No rank ever holds a sharded cache leaf whole: after every decode
    pass and every engine step (spills and resumes included) each leaf
    has the shape of this rank's block, and an engine's pool is its
    block of the mesh-less pool (a quarter where ``model`` 4 shards the
    KV heads)."""
    _, _, port, meshless, _ = runs
    for r in range(4):
        assert not port[r]["bad"], port[r]["bad"][:5]
    if mesh == "model4":
        for mode in ("slot", "paged"):
            want = meshless[("qwen1.5-4b", mode + "_pool_bytes")] // 4
            assert port[0][mesh]["qwen1.5-4b"][mode + "_pool_bytes"] == want


def test_a_mesh_needs_a_process_group():
    """A mesh given without an initialised process group raises, as the
    train launcher does; nothing falls back to the mesh-less path."""
    cfg = get_config("qwen1.5-4b", reduced=True)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                 device=torch.device("cpu"))
    params = params_from_jax(_jax_params("qwen1.5-4b"), cfg)
    with pytest.raises(RuntimeError, match="process group"):
        generate(params, cfg, torch.zeros((1, 2), dtype=torch.long), 2,
                 mesh=mesh)
    with pytest.raises(RuntimeError, match="process group"):
        ServeEngine(cfg, params=params, mesh=mesh)
