"""The port's pipeline train step (``make_sharded_train_step``) on the
CPU, over gloo ranks spawned by ``repro_torch.launch.mesh.run_ranks``
(``tests/torch_dist_ranks.py``), each world at a ``file://`` path under
``tmp_path`` and with a deadline of its own (``RANK_DEADLINE_S``).

Held: against the reference's own sharded step on the same mesh shapes
(the reference in a subprocess with as many host devices as the port has
ranks) at the dense train-step bounds of ROADMAP §C; against the port's
mesh-less step over 4 steps at the reference test's bounds
(``tests/test_dist.py::test_sharded_pipeline_step_matches_plain``), with
1f1b equal to gpipe exactly; and the multi-pod test's compressed
reduction (``test_multipod_grads_route_through_compressed_psum``)."""

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_data as jax_make_data
from repro.models import lm as jlm
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.train import TrainState, compute_grads, make_train_step

RANK_DEADLINE_S = 180


def _run(tmp_path, name, *args):
    run_ranks(ranks.sharded_steps, 4, str(tmp_path), name, *args,
              init_method=f"file://{tmp_path}/pg_{name}",
              timeout_s=RANK_DEADLINE_S)
    return torch.load(tmp_path / f"{name}.pt", weights_only=False)


def _jax_params(cfg_kw):
    jcfg = jax_get_config("stablelm-3b", reduced=True).replace(**cfg_kw)
    return jcfg, jax.tree.map(np.asarray,
                              jlm.init_model(jcfg, jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(a, b, rel):
    return abs(float(a) - float(b)) <= rel * abs(float(b))


_REF_STEP = """
import jax, jax.numpy as jnp, numpy as np
from repro import optim
from repro.configs import get_config
from repro.data.pipeline import make_data
from repro.launch.mesh import make_host_mesh
from repro.models import lm
from repro.train.step import TrainState, make_sharded_train_step
cfg = get_config("stablelm-3b", reduced=True).replace(**CFG_KW)
mesh = make_host_mesh(**MESH_KW)
params = lm.init_model(cfg, jax.random.PRNGKey(0))
opt = optim.adamw(optim.constant_schedule(1e-3), b1=0.0, weight_decay=0.1)
state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
step = jax.jit(make_sharded_train_step(cfg, opt, mesh, compress_pod=False))
state, m = step(state, make_data(cfg, 16, 8).batch_at(0))
def flat(t, pre=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from flat(t[k], pre + "/" + k)
    else:
        yield pre, np.asarray(t)
np.savez("OUT", loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
         **{"mu" + k: v for k, v in flat(state.opt_state.mu)})
print(dict(mesh.shape))
"""

MESHES = {"pipe2_model2": dict(pipe=2, model=2),
          "pipe2_data2": dict(pipe=2, data=2),
          "pod2_pipe2": dict(pipe=2, pods=2)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_reference_sharded_step(tmp_path, subproc, mesh):
    """One step of reduced stablelm-3b (4 layers; the reference's batch 0
    of seq 16 x 8) from the reference's parameters, on the same mesh
    shape in both packages (pod grads in f32, so that gradients are the
    step's own): the loss within 1e-5 relative; each assembled gradient
    (AdamW's first moment at b1 = 0 after one step, exactly the gradient)
    within 1e-5 plus twice the reference's own error against the port's
    f64 mesh-less gradient, which must lie within 1e-2 of that leaf's
    largest entry; the grad-norm metric within 3e-4 relative (ROADMAP §C,
    the dense train step's bounds)."""
    mesh_kw = MESHES[mesh]
    cfg_kw = dict(n_layers=4, pipeline_microbatches=2 if "pods" in mesh_kw
                  else 4)
    out = subproc(_REF_STEP.replace("CFG_KW", repr(cfg_kw))
                  .replace("MESH_KW", repr(mesh_kw))
                  .replace("OUT", str(tmp_path / "ref.npz")), n_devices=4)
    ref = np.load(tmp_path / "ref.npz")
    jcfg, jparams = _jax_params(cfg_kw)
    nb = jax_make_data(jcfg, 16, 8).batch_at(0)
    port = _run(tmp_path, mesh, cfg_kw, mesh_kw, jparams, [nb],
                {"step": {"compress_pod": False}}, "grads")
    assert str(port["mesh"]) in out   # the same mesh shape, in axis order
    m = port["step"]["metrics"][0]
    assert _close(m["loss"], ref["loss"], 1e-5), (m["loss"], ref["loss"])
    assert _close(m["grad_norm"], ref["grad_norm"], 3e-4)

    cfg64 = get_config("stablelm-3b", reduced=True).replace(
        dtype="float64", **cfg_kw)
    _, exact = compute_grads(params_from_jax(jparams, cfg64),
                             {k: torch.from_numpy(v) for k, v in nb.items()},
                             cfg64)
    exact = dict(_flat(exact))
    assert sorted(exact) == sorted(port["step"]["mu"])
    for path, got in port["step"]["mu"].items():
        want, e = ref["mu" + path], exact[path].numpy()
        jax_err = float(np.abs(want - e).max())
        assert jax_err <= 1e-2 * float(np.abs(e).max()), (path, jax_err)
        np.testing.assert_allclose(got, want, atol=1e-5 + 2 * jax_err,
                                   rtol=0, err_msg=path)


PORT_MESHES = {"pipe4": dict(pipe=4), "pipe2_model2": dict(pipe=2, model=2),
               "pipe2_data2": dict(pipe=2, data=2)}


@pytest.mark.parametrize("mesh", sorted(PORT_MESHES))
def test_sharded_step_matches_meshless_step(tmp_path, mesh):
    """Four steps of reduced stablelm-3b (4 layers, 4 microbatches,
    AdamW with clipping) from the same parameters and batches: each
    step's loss within 1e-4 relative of the port's mesh-less step, the
    last grad-norm within 1e-3 relative; gpipe and 1f1b agree exactly,
    metrics and parameters."""
    cfg_kw = dict(n_layers=4, pipeline_microbatches=4)
    cfg = get_config("stablelm-3b", reduced=True).replace(**cfg_kw)
    _, jparams = _jax_params(cfg_kw)
    batches = [jax_make_data(
        jax_get_config("stablelm-3b", reduced=True), 16, 8).batch_at(i)
        for i in range(4)]
    port = _run(tmp_path, mesh, cfg_kw, PORT_MESHES[mesh], jparams, batches,
                {"gpipe": {"schedule": "gpipe"}, "1f1b": {"schedule": "1f1b"}},
                "adamw")
    opt = optim.adamw(optim.constant_schedule(1e-3), weight_decay=0.1,
                      max_grad_norm=1.0)
    params = params_from_jax(jparams, cfg)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, opt)
    for i, b in enumerate(batches):
        state, mp = step(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        mg, mo = port["gpipe"]["metrics"][i], port["1f1b"]["metrics"][i]
        assert np.isfinite(mg["loss"])
        assert _close(mg["loss"], mp["loss"], 1e-4), (i, mg, float(mp["loss"]))
        assert mo == mg, (i, mo, mg)
    assert _close(mg["grad_norm"], mp["grad_norm"], 1e-3)
    for path, p in port["gpipe"]["params"].items():
        np.testing.assert_array_equal(port["1f1b"]["params"][path], p)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "olmoe-1b-7b"])
def test_sharded_step_other_families_match_meshless(tmp_path, arch):
    """The pipeline step of the ssm and moe families (no TP path: the
    model axis stays 1) on (pipe=2, data=2), reduced, 2 microbatches: two
    steps' losses within 1e-4 and the last grad-norm within 1e-3 relative
    of the mesh-less step's, from the reference's parameters."""
    jcfg = jax_get_config(arch, reduced=True).replace(pipeline_microbatches=2)
    jparams = jax.tree.map(np.asarray,
                           jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    batches = [jax_make_data(jcfg, 16, 8).batch_at(i) for i in range(2)]
    port = _run(tmp_path, arch, dict(pipeline_microbatches=2),
                dict(pipe=2, data=2), jparams, batches, {"gpipe": {}},
                "adamw", arch)
    cfg = get_config(arch, reduced=True)
    opt = optim.adamw(optim.constant_schedule(1e-3), weight_decay=0.1,
                      max_grad_norm=1.0)
    params = params_from_jax(jparams, cfg)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, opt)
    for i, b in enumerate(batches):
        state, mp = step(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        mg = port["gpipe"]["metrics"][i]
        assert _close(mg["loss"], mp["loss"], 1e-4), (i, mg, float(mp["loss"]))
    assert _close(mg["grad_norm"], mp["grad_norm"], 1e-3)


def test_multipod_grads_route_through_compressed_psum(tmp_path):
    """``tests/test_dist.py::test_multipod_grads_route_through_compressed_psum``
    for the port, on (pod=2, pipe=2): 5 steps (2 microbatches) with the
    compressed reduction overlapped (per group, the default), monolithic,
    and in f32.  ``compressed_psum`` runs, the residuals (global shape
    (pod, *param)) end non-zero, the overlapped and monolithic runs agree
    exactly, and the compressed loss lies within 2e-2 of the f32 one."""
    cfg_kw = dict(n_layers=4, pipeline_microbatches=2)
    jcfg, jparams = _jax_params(cfg_kw)
    batches = [jax_make_data(jcfg, 16, 8).batch_at(i) for i in range(5)]
    port = _run(tmp_path, "multipod", cfg_kw, dict(pipe=2, pods=2), jparams,
                batches, {"compressed": {},
                          "monolithic": {"overlap_pod_reduce": False},
                          "f32": {"compress_pod": False}}, "adamw")
    c, o, f = port["compressed"], port["monolithic"], port["f32"]
    assert c["compressed_calls"] and o["compressed_calls"]
    assert not f["compressed_calls"] and f["ef_l1"] is None
    assert c["ef_l1"] > 0, "error-feedback residual stayed zero"
    for path, shape in c["ef_shapes"].items():
        assert shape == (2,) + c["params"][path].shape
    assert o["metrics"] == c["metrics"], "overlap changed the math"
    for path, p in c["params"].items():
        np.testing.assert_array_equal(o["params"][path], p)
    lc, lf = c["metrics"][-1]["loss"], f["metrics"][-1]["loss"]
    assert np.isfinite(lc) and abs(lc - lf) / abs(lf) < 2e-2, (lc, lf)
