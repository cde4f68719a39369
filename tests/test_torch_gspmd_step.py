"""The port's GSPMD train step (``make_train_step(mesh=...)``) of reduced
stablelm-3b (the dense family) on the CPU, over 4 gloo ranks spawned by
``repro_torch.launch.mesh.run_ranks`` (``tests/torch_gspmd_ranks.py``),
held against the reference's own ``make_train_step(mesh=...)`` on the
same mesh shape with ``AxisType.Auto`` axes (``tests/gspmd_reference.py``,
run once for the file): (data=2, model=2), (model=4), (pod=2,
data=2) and (pipe=2, data=2), two microbatches on (data=2, model=2), and ``seq_parallel`` on
(data=2, model=2) and (model=4), remat with ``remat_policy="dots"`` on
(data=2, model=2) against the reference's ``dots_saveable`` step, on
the inputs of ``tests/test_torch_train.py::test_train_step_matches_jax``
(whose bounds these are).  The dense function does not depend on the
mesh, so the f64 yardstick is the port's mesh-less step.  Where
``model`` splits the vocabulary (every case here: 256 over 2 or 4) the
step's embedding, head and loss are vocabulary-parallel; one port-only
case, a vocabulary of 250 on (model=4), takes the rules' fallback (the
table whole) and is held against the port's mesh-less step."""

import pytest
import torch

import gspmd_reference as gref
import torch_gspmd_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.train import compute_grads

RANK_DEADLINE_S = 240
ARCH = "stablelm-3b"
# test_train_step_matches_jax's batch: seq 32 x 4 of seed 5, batch 2
DATA = dict(seq=32, batch=4, seed=5, first=2)

CASES = {
    "data2_model2": dict(mesh=dict(model=2)),
    "model4": dict(mesh=dict(model=4)),
    "pod2_data2": dict(mesh=dict(pods=2)),
    "data2_model2_micro2": dict(mesh=dict(model=2), micro=2),
    "data2_model2_sp": dict(mesh=dict(model=2),
                            cfg_kw=dict(seq_parallel=True)),
    "model4_sp": dict(mesh=dict(model=4), cfg_kw=dict(seq_parallel=True)),
    # the GSPMD step ignores a pipe axis (its ranks replicas), as the
    # reference's jit does: the dry run's fallback where the pipeline step
    # cannot stage a config
    "pipe2_data2": dict(mesh=dict(pipe=2)),
    "data2_model2_dots": dict(mesh=dict(model=2),
                              cfg_kw=dict(remat=True, remat_policy="dots")),
}
# port-only: a vocabulary that model 4 does not divide
FALLBACK = dict(mesh=dict(model=4), cfg_kw=dict(vocab=250))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The reference's step for every case, then the port's on 4 ranks
    from the reference's parameters, one world for the file."""
    d = tmp_path_factory.mktemp("gspmd_step")
    ref = gref.run_reference(subproc, d, [
        dict(name=k, arch=ARCH, **DATA, **v) for k, v in CASES.items()])
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import make_data as jax_make_data
    batch = jax_make_data(jax_get_config(ARCH, reduced=True), DATA["seq"],
                          DATA["batch"], DATA["seed"]).batch_at(DATA["first"])
    cases = {k: dict(arch=ARCH, cfg_kw=v.get("cfg_kw", {}),
                     mesh_kw=v["mesh"], micro=v.get("micro", 1),
                     params=gref.params_of(ref[k]), batches=[batch])
             for k, v in CASES.items()}
    cases["fallback"] = fallback_case()
    run_ranks(ranks.gspmd_steps, 4, str(d), "steps", cases,
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    port = torch.load(d / "steps.pt", weights_only=False)
    cfg64 = get_config(ARCH, reduced=True).replace(dtype="float64")
    _, exact = compute_grads(
        params_from_jax(ranks.unflat(gref.params_of(ref["model4"])), cfg64),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg64)
    return ref, port, {k: v.numpy() for k, v in ranks.flat(exact)}, \
        cases["fallback"]


def fallback_case():
    """``FALLBACK``'s case for the ranks: the port's seeded parameters of
    reduced stablelm-3b at a vocabulary of 250, and a batch of its data
    (``DATA``'s shape)."""
    from repro_torch.data.pipeline import make_data
    from repro_torch.models import lm
    cfg = get_config(ARCH, reduced=True).replace(**FALLBACK["cfg_kw"])
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    batch = make_data(cfg, DATA["seq"], DATA["batch"],
                      DATA["seed"]).batch_at(DATA["first"])
    return dict(arch=ARCH, cfg_kw=FALLBACK["cfg_kw"],
                mesh_kw=FALLBACK["mesh"],
                params={k: v.numpy() for k, v in ranks.flat(params)},
                batches=[batch])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gspmd_step_matches_reference_sharded_step(runs, case):
    """One step from the reference's parameters (``DATA``;
    AdamW at b1 = 0, so that its first moment is the gradient): the
    loss within 1e-5 relative, each gradient leaf within 1e-5 plus twice
    the reference's own error against the f64 gradient, the grad-norm
    within 3e-4 relative plus twice its error, and the parameters after
    the step as those bounds allow (``gspmd_reference.hold_step``: the
    dense train step's bounds of ROADMAP §C)."""
    ref, port, exact, _ = runs
    assert port[case]["mesh"] == eval(str(ref[case]["mesh"]))
    gref.hold_step(port[case], ref[case], exact, factor=2)


def test_gspmd_step_vocabulary_fallback_matches_meshless_step(runs):
    """A vocabulary of 250 on (model=4): the rules replicate the table
    over ``model`` (250 does not split 4 ways), and the step computes
    whole logits and the plain loss on every rank.  Held against the
    port's own mesh-less step from the same parameters and batch at the
    dense bounds (``hold_step``, factor 2 on the mesh-less step's error
    against its f64 gradient)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import lm
    from repro_torch.train import make_train_step
    from repro_torch.train.step import TrainState
    _, port, _, case = runs
    assert port["fallback"]["mesh"] == {"data": 1, "model": 4}
    cfg = get_config(ARCH, reduced=True).replace(**case["cfg_kw"])
    specs = shd.param_shardings(
        lm.model_spec(cfg), AbstractMesh((1, 4), ("data", "model")))
    assert specs["embed"]["table"][0] is None
    params = params_from_jax(ranks.unflat(case["params"]), cfg)
    batch = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    opt = ranks.optimizer("grads")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    state, m = make_train_step(cfg, opt)(state, batch)
    meshless = {"loss0": float(m["loss"]), "gnorm0": float(m["grad_norm"])}
    meshless.update({"mu" + k: v.numpy()
                     for k, v in ranks.flat(state.opt_state.mu)})
    meshless.update({"p1" + k: v.numpy()
                     for k, v in ranks.flat(state.params)})
    cfg64 = cfg.replace(dtype="float64")
    _, exact = compute_grads(
        params_from_jax(ranks.unflat(case["params"]), cfg64),
        {k: torch.from_numpy(v) for k, v in case["batches"][0].items()},
        cfg64)
    gref.hold_step(port["fallback"], meshless,
                   {k: v.numpy() for k, v in ranks.flat(exact)}, factor=2)
