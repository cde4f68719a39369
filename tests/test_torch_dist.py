"""The port's distribution layer against the JAX package, on the CPU:
the pipeline schedules' tables, the mesh shapes, the sharding rules, the
pipeline step's eager validation, the named-axis collectives and the
compressed pod reduction.

Pure parts (tables, shapes, specs, validation) must equal the
reference's exactly.  Multi-rank parts spawn their ranks with
``repro_torch.launch.mesh.run_ranks`` over gloo, each world's process
group at a ``file://`` path under the test's ``tmp_path`` (so concurrent
workers never share a port), with a deadline of its own
(``RANK_DEADLINE_S``) after which the ranks are killed and the test
fails."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_ranks as ranks
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jshd
from repro.launch import mesh as jmesh
from repro_torch.dist import pipeline as tpipe
from repro_torch.dist import sharding as tshd
from repro_torch.launch import mesh as tmesh

RANK_DEADLINE_S = 120


def _run(tmp_path, fn, world, *args):
    tmesh.run_ranks(fn, world, *args,
                    init_method=f"file://{tmp_path}/pg_{fn.__name__}",
                    timeout_s=RANK_DEADLINE_S)


def _load(tmp_path, name):
    return torch.load(tmp_path / name, weights_only=False)


# ---------------------------------------------------------------------------
# schedule tables
# ---------------------------------------------------------------------------

def _table_or_error(sched, M, S):
    try:
        return [dataclasses.astuple(o) for o in sched.table(M, S)]
    except RuntimeError as e:
        return ("RuntimeError", str(e))


@pytest.mark.parametrize("S", range(1, 7))
@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
def test_schedule_tables_match_reference(name, S):
    """Tables, forward rows, ring capacities, peaks and bubble fractions
    equal to the reference's for M in 1-12, bit for bit."""
    want, got = jpipe.get_schedule(name), tpipe.get_schedule(name)
    for M in range(1, 13):
        table = _table_or_error(got, M, S)
        assert table == _table_or_error(want, M, S), (name, S, M)
        rows = got.forward_rows(M, S)
        assert rows == want.forward_rows(M, S), (name, S, M)
        assert tpipe._ring_capacity(rows, S) \
            == jpipe._ring_capacity(rows, S), (name, S, M)
        assert got.peak_live_microbatches(M, S) \
            == want.peak_live_microbatches(M, S), (name, S, M)
        assert got.bubble_fraction(M, S) == want.bubble_fraction(M, S)


def test_schedule_errors_match_reference():
    """The same ValueErrors: a non-monotone forward order, an unknown
    schedule name."""
    bad = [(0, 0, 1, "F"), (1, 0, 0, "F"), (2, 0, 0, "B"), (3, 0, 1, "B")]
    msgs = []
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError) as e:
            mod._table_to_fwd_rows([mod.MicroOp(*op) for op in bad], 1)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.get_schedule("pipedream-2bw")
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_port_schedule_tables_cover_all_ops_once():
    """``tests/test_dist.py::test_schedule_tables_cover_all_ops_once``."""
    for name, cls in tpipe.SCHEDULES.items():
        for S, M in ((2, 4), (4, 8), (4, 2), (3, 5)):
            table = cls().table(M, S)
            fwd = {(o.stage, o.micro) for o in table if o.phase == "F"}
            bwd = {(o.stage, o.micro) for o in table if o.phase == "B"}
            want = {(s, m) for s in range(S) for m in range(M)}
            assert fwd == bwd == want, (name, S, M)
            assert len(table) == 2 * S * M, (name, S, M)


def test_port_1f1b_bounds_peak_live_activations():
    """``tests/test_dist.py::test_1f1b_bounds_peak_live_activations``."""
    g, o = tpipe.GPipeSchedule(), tpipe.OneFOneBSchedule()
    for S, M in ((2, 8), (4, 8), (3, 12)):
        assert g.peak_live_microbatches(M, S) == M
        assert o.peak_live_microbatches(M, S) == min(S, M)
        assert o.peak_live_microbatches(M, S) < g.peak_live_microbatches(M, S)
        assert abs(g.bubble_fraction(M, S) - o.bubble_fraction(M, S)) < 1e-9
    assert o.peak_live_microbatches(2, 4) == 2


def test_port_get_schedule_rejects_unknown_names():
    """``tests/test_dist.py::test_get_schedule_rejects_unknown_names``."""
    with pytest.raises(ValueError, match="1f1b"):
        tpipe.get_schedule("pipedream-2bw")
    assert tpipe.get_schedule("1f1b").name == "1f1b"
    assert tpipe.get_schedule(tpipe.get_schedule("gpipe")).name == "gpipe"


# ---------------------------------------------------------------------------
# mesh shapes
# ---------------------------------------------------------------------------

HOST_CASES = [(8, {}), (8, dict(model=2)), (8, dict(pipe=4)),
              (8, dict(model=2, pipe=2)), (8, dict(pipe=2, pods=2)),
              (16, dict(model=2, pipe=2, pods=2)), (4, dict(pipe=2, model=2)),
              (4, dict(pipe=2, data=2)), (4, dict(pods=2, pipe=2)),
              (4, dict(pipe=4)), (1, {}), (8, dict(pipe=3)),
              (6, dict(model=4)), (8, dict(data=2, model=2, pipe=2)),
              (8, dict(data=3, model=2)), (8, dict(pipe=0, pods=0))]


@pytest.mark.parametrize("n,kw", HOST_CASES)
def test_host_mesh_shape_matches_reference(n, kw):
    try:
        want = jmesh.host_mesh_shape(n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.host_mesh_shape(n, **kw)
        return
    assert tmesh.host_mesh_shape(n, **kw) == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_matches_reference(monkeypatch, multi_pod):
    """The reference builds its production mesh with ``jax.make_mesh``
    over 256 or 512 devices; its shape arithmetic is read by standing in
    for that call."""
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (shape,
                                                                      axes))
    for pipe in (1, 2, 3, 4, 5, 8, 16, 32):
        try:
            want = jmesh.make_production_mesh(multi_pod=multi_pod, pipe=pipe)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tmesh.production_mesh_shape(multi_pod=multi_pod, pipe=pipe)
            continue
        assert tmesh.production_mesh_shape(multi_pod=multi_pod,
                                           pipe=pipe) == want


def test_a_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_host_mesh(pipe=2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.init_distributed("cpu")
    assert tmesh.pick_backend("cpu", 4) == "gloo"


def test_a_finished_rank_skips_the_interpreter_teardown(tmp_path):
    """A rank whose work is done leaves without the interpreter's
    teardown: a teardown that aborts (here an ``atexit`` abort; under
    load, gloo's native state in ``test_sharded_step_matches_meshless_step
    [pipe4]``, ROADMAP §C) no longer fails a run whose results are
    written."""
    _run(tmp_path, ranks.abort_at_exit, 2, str(tmp_path))
    assert [_load(tmp_path, f"done_{r}.pt") for r in range(2)] == [0, 1]


# ---------------------------------------------------------------------------
# sharding rules, on the same abstract meshes
# ---------------------------------------------------------------------------

MESHES = [((4,), ("model",)), ((2, 4), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model")), ((4,), ("pipe",)),
          ((4, 2), ("data", "model")), ((1, 1), ("data", "model")),
          ((2, 2, 2), ("pipe", "data", "model")),
          ((2, 2, 1), ("pipe", "data", "model")),
          ((4, 2, 1), ("pipe", "data", "model")),
          ((2, 2, 1, 1), ("pod", "pipe", "data", "model")),
          ((2, 1, 2), ("pipe", "data", "model"))]
ARCHS = ["stablelm-3b", "gemma3-1b", "mamba2-1.3b", "deepseek-v2-lite-16b",
         "olmoe-1b-7b", "qwen1.5-4b", "zamba2-2.7b"]


def _meshes(shape, names):
    return (jax.sharding.AbstractMesh(tuple(shape), tuple(names)),
            tmesh.AbstractMesh(shape, names))


def _same(port_tree, ref_tree):
    """Every port spec equals the reference's entry for entry."""
    from repro_torch.utils.tree import tree_leaves
    want = jax.tree.leaves(ref_tree, is_leaf=lambda x: isinstance(x, JP))
    got = tree_leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tshd.P)
        assert tuple(g) == tuple(w), (g, w)


def _specs(arch):
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    return (jlm.model_spec(jget(arch, reduced=True)),
            lm.model_spec(get_config(arch, reduced=True)))


@pytest.mark.parametrize("shape,names", MESHES)
def test_spec_rules_match_reference(shape, names):
    """spec_for_axes (with and without shapes), dp helpers, batch_spec,
    cache_sharding over a grid of shapes, and each family's logical specs
    and pipeline-step specs."""
    jm, tm = _meshes(shape, names)
    axes_cases = [("embed", "mlp"), ("vocab", "mlp"), ("layers", "embed",
                                                       "mlp"),
                  (None, "nonesuch"), ("heads", "kv_heads"),
                  ("experts", "embed", "mlp"), ("embed",)]
    for axes in axes_cases:
        for dims in (None, (64,) * len(axes), (63,) * len(axes),
                     (8, 64, 30)[:len(axes)], (30, 32, 96)[:len(axes)]):
            assert tuple(tshd.spec_for_axes(axes, tm, dims)) \
                == tuple(jshd.spec_for_axes(axes, jm, dims))
    assert tshd.dp_axes(tm) == jshd.dp_axes(jm)
    for fn in ("dp_size", "model_size", "pipe_size", "axis_sizes"):
        assert getattr(tshd, fn)(tm) == getattr(jshd, fn)(jm)
    for batch in (1, 3, 6, 8, 16):
        for ndim in (1, 2, 3):
            assert tuple(tshd.batch_spec(tm, batch, ndim)) \
                == tuple(jshd.batch_spec(jm, batch, ndim))
        for seq in (1021, 1024, 96):
            for kv in (1, 2, 3, 8):
                assert tuple(tshd.cache_sharding(tm, batch, seq, kv)) \
                    == tuple(jshd.cache_sharding(jm, batch, seq, kv))
    for arch in ARCHS:
        jspec, tspec = _specs(arch)
        _same(tshd.logical_specs(tspec, tm), jshd.logical_specs(jspec, jm))
        _same(tshd.param_shardings(tspec, tm), jshd.logical_specs(jspec, jm))
        for mesh_arg in ((None, None), (jm, tm)):
            _same(tshd.sharded_param_specs(tspec, mesh=mesh_arg[1]),
                  jshd.sharded_param_specs(jspec, mesh=mesh_arg[0]))
            _same(tshd.sharded_ef_specs(tspec, mesh=mesh_arg[1]),
                  jshd.sharded_ef_specs(jspec, mesh=mesh_arg[0]))


@pytest.mark.parametrize("shape,names", MESHES)
def test_cache_specs_match_reference(monkeypatch, shape, names):
    """decode_cache_shardings' and kv_pool_shardings' leaf rules on every
    family's dense and paged caches.  The reference wraps each spec in a
    ``NamedSharding``; standing in for that constructor reads the spec."""
    from repro.configs import get_config as jget
    from repro.serve import decode as jdecode
    from repro_torch.configs import get_config
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    jm, tm = _meshes(shape, names)
    for arch in ARCHS:
        jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
        for batch, seq in ((2, 64), (8, 1024), (1, 96)):
            caches = jax.eval_shape(lambda: jdecode.init_caches(jcfg, batch,
                                                                seq))
            _same(tshd.decode_cache_shardings(cfg, caches, tm),
                  jshd.decode_cache_shardings(jcfg, caches, jm))
            _same(tshd.kv_pool_shardings(cfg, caches, tm),
                  jshd.kv_pool_shardings(jcfg, caches, jm))
        if jcfg.family == "encdec" or not hasattr(jdecode,
                                                   "paged_cache_kinds"):
            continue
        kinds = jdecode.paged_cache_kinds(jcfg)
        paged = jax.eval_shape(lambda: jdecode.init_paged_caches(
            jcfg, 12, 16, 4))
        _same(tshd.kv_pool_shardings(cfg, paged, tm, kinds),
              jshd.kv_pool_shardings(jcfg, paged, jm, kinds))


def test_stage_leaf_specs_need_logical_axes_under_tp():
    tm = tmesh.AbstractMesh((2, 1, 2), ("pipe", "data", "model"))
    with pytest.raises(TypeError, match="ParamSpec"):
        tshd.sharded_param_specs({"layers": {"w": torch.zeros(2, 4)}},
                                 mesh=tm)


# ---------------------------------------------------------------------------
# the pipeline step's eager validation
# ---------------------------------------------------------------------------

def _validation_cases(get_config):
    cfg = get_config("stablelm-3b", reduced=True)
    m = ((2, 2, 2), ("pipe", "data", "model"))
    return [
        (cfg, ((2, 4), ("data", "model")), {}),
        (cfg, m, {}),
        (cfg.replace(d_ff=cfg.d_ff + 1), m, {}),
        (cfg.replace(n_heads=6, n_kv_heads=3), m, {}),
        (get_config("mamba2-1.3b", reduced=True), m, {}),
        (cfg, ((2, 2, 1), ("pipe", "data", "model")),
         {"schedule": "interleaved"}),
        (cfg.replace(n_layers=2), ((4, 2, 1), ("pipe", "data", "model")), {}),
        (get_config("zamba2-2.7b", reduced=True),
         ((2, 2, 1), ("pipe", "data", "model")), {}),
        (get_config("deepseek-v2-lite-16b", reduced=True),
         ((2, 2, 1), ("pipe", "data", "model")), {}),
        (get_config("olmoe-1b-7b", reduced=True), m, {}),
        (get_config("gemma3-1b", reduced=True), m, {}),
        (get_config("chameleon-34b", reduced=True), m, {}),
        (get_config("whisper-large-v3", reduced=True),
         ((2, 2, 1), ("pipe", "data", "model")), {}),
        (get_config("mamba2-1.3b", reduced=True),
         ((2, 2, 1), ("pipe", "data", "model")), {}),
        (cfg.replace(pipeline_schedule="1f1b"), m, {}),
    ]


@pytest.mark.parametrize("case", range(15))
def test_make_sharded_train_step_validates_like_reference(case):
    """Each case of ``tests/test_sharding_unit.py::
    test_make_sharded_train_step_validates_eagerly`` and more: the port
    raises ``PipelineStepError`` (a ``ValueError``) with the reference's
    message wherever the reference does, and builds a step wherever the
    reference does."""
    from repro import optim as joptim
    from repro.configs import get_config as jget
    from repro.train.step import PipelineStepError as JErr
    from repro.train.step import make_sharded_train_step as jmake
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.train.step import PipelineStepError, \
        make_sharded_train_step
    jcfg, (shape, names), kw = _validation_cases(jget)[case]
    cfg, _, _ = _validation_cases(get_config)[case]
    jm, tm = _meshes(shape, names)
    try:
        jmake(jcfg, joptim.adamw(joptim.constant_schedule(1e-3)), jm, **kw)
        want = None
    except JErr as e:
        want = str(e)
    opt = optim.adamw(optim.constant_schedule(1e-3))
    if want is None:
        assert make_sharded_train_step(cfg, opt, tm, **kw) is not None
    else:
        with pytest.raises(PipelineStepError) as e:
            make_sharded_train_step(cfg, opt, tm, **kw)
        assert isinstance(e.value, ValueError) and str(e.value) == want


# ---------------------------------------------------------------------------
# collectives, the standalone pipeline and the compressed reduction
# ---------------------------------------------------------------------------

def test_collectives_forward_and_gradient(tmp_path):
    """On a (pipe=2, model=2) mesh of 4 ranks, rank r holds x_r and weighs
    its output by c_r.  Forward: psum / pmean / ppermute equal the sums
    and moves computed in one process.  Gradient of x_r: the gradient of
    the summed loss sum_r <c_r, y_r> (JAX's transpose: psum's cotangent
    is psummed, ppermute's goes back along the inverse permutation),
    within 1e-6 (sums of at most 4 f32 terms)."""
    _run(tmp_path, ranks.collectives, 4, str(tmp_path))
    outs = [_load(tmp_path, f"collectives_{r}.pt") for r in range(4)]
    xs, cs = [], []
    for r in range(4):
        gen = np.random.default_rng(r)
        xs.append(gen.standard_normal((3, 5)).astype(np.float32))
        cs.append(gen.standard_normal((3, 5)).astype(np.float32))
    coord = {r: (o["coords"]["pipe"], o["coords"]["model"])
             for r, o in enumerate(outs)}
    at = {v: r for r, v in coord.items()}
    for r, o in enumerate(outs):
        p, m = coord[r]
        assert o["axis_index"] == (p, m)
        assert "backend gloo" in o["repr"] and "transport host" in o["repr"]
        model_peers = [at[(p, j)] for j in range(2)]
        pipe_peers = [at[(i, m)] for i in range(2)]
        want = {
            "psum_model": (sum(xs[q] for q in model_peers),
                           sum(cs[q] for q in model_peers)),
            "psum_both": (sum(xs), sum(cs)),
            "pmean_pipe": (sum(xs[q] for q in pipe_peers) / 2,
                           sum(cs[q] for q in pipe_peers) / 2),
            "ring_pipe": (xs[at[(1 - p, m)]], cs[at[(1 - p, m)]]),
            "shift_model": (xs[at[(p, 0)]] if m == 1 else 0 * xs[r],
                            cs[at[(p, 1)]] if m == 0 else 0 * cs[r]),
        }
        for name, (y, g) in want.items():
            np.testing.assert_allclose(o[name][0], y, atol=1e-6, rtol=0,
                                       err_msg=f"{name} forward, rank {r}")
            np.testing.assert_allclose(o[name][1], g, atol=1e-6, rtol=0,
                                       err_msg=f"{name} gradient, rank {r}")


def test_gpipe_and_1f1b_match_sequential(tmp_path):
    """``tests/test_dist.py::test_gpipe_matches_sequential`` for the port
    (S 4, M 8, mb 2, d 16; atol 1e-5), by gpipe and by the 1f1b runner,
    which must agree exactly."""
    rng = np.random.default_rng(0)
    S, M, mb, d = 4, 8, 2, 16
    ws = (rng.standard_normal((S, d, d)) / d ** 0.5).astype(np.float32)
    xs = rng.standard_normal((M, mb, d)).astype(np.float32)
    _run(tmp_path, ranks.pipelined, 4, str(tmp_path), ws, xs)
    want = xs
    for s in range(S):
        want = np.tanh(want @ ws[s])
    for r in range(4):
        out = _load(tmp_path, f"pipelined_{r}.pt")
        np.testing.assert_allclose(out["gpipe"], want, atol=1e-5)
        np.testing.assert_array_equal(out["1f1b"], out["gpipe"])


_REF_COMPRESS = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist.compress import compressed_psum
z = np.load("IN")
mesh = jax.make_mesh((2,), ("pod",))
fn = jax.shard_map(lambda g, e: compressed_psum({"w": g}, {"w": e}, "pod"),
                   mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P(), P("pod")), check_vma=False)
err = {"w": jnp.asarray(z["err0"])}
avgs, errs = [], []
for _ in range(STEPS):
    avg, err = fn(jnp.asarray(z["g"]), err["w"])
    avgs.append(np.asarray(avg["w"])); errs.append(np.asarray(err["w"]))
np.savez("OUT", avg=np.stack(avgs), err=np.stack(errs))
"""


def test_compressed_psum_bit_equal_to_reference(tmp_path, subproc):
    """Two pods, three steps from a non-zero residual: the port's mean and
    residual equal the reference's bit for bit (bf16 sums of two terms,
    one rounding each)."""
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((2, 256)) * 1e-3).astype(np.float32)
    err0 = (rng.standard_normal((2, 256)) * 1e-6).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, err0=err0)
    subproc(_REF_COMPRESS.replace("IN", str(tmp_path / "in.npz"))
            .replace("OUT", str(tmp_path / "out.npz"))
            .replace("STEPS", "3"), n_devices=2)
    ref = np.load(tmp_path / "out.npz")
    _run(tmp_path, ranks.compressed, 2, str(tmp_path), g, err0, 3)
    outs = [_load(tmp_path, f"compressed_{r}.pt") for r in range(2)]
    for i in range(3):
        for r in range(2):
            np.testing.assert_array_equal(outs[r]["avg"][i][0],
                                          ref["avg"][i][0])
            np.testing.assert_array_equal(outs[r]["err"][i][0],
                                          ref["err"][i][r])


def test_compressed_psum_error_feedback_converges(tmp_path):
    """``tests/test_dist.py::test_compressed_psum_error_feedback`` for the
    port at 4 ranks: over 20 steps the summed bf16 means track the summed
    true means within 2e-2 of their largest entry."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((4, 64)) * 1e-3).astype(np.float32)
    _run(tmp_path, ranks.compressed, 4, str(tmp_path), g,
         np.zeros_like(g), 20)
    out = _load(tmp_path, "compressed_0.pt")
    acc_c = sum(a[0].astype(np.float64) for a in out["avg"])
    acc_t = 20 * g.astype(np.float64).mean(axis=0)
    rel = np.abs(acc_c - acc_t).max() / (np.abs(acc_t).max() + 1e-12)
    assert rel < 0.02, rel
    # and each step is a real quantization: the residual moves
    assert any(np.abs(e).sum() > 0 for e in out["err"])
