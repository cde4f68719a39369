"""The port's GSPMD train step (``make_train_step(mesh=...)``) of reduced
stablelm-3b (the dense family) on the CPU, over 4 gloo ranks spawned by
``repro_torch.launch.mesh.run_ranks`` (``tests/torch_gspmd_ranks.py``),
held against the reference's own ``make_train_step(mesh=...)`` on the
same mesh shape with ``AxisType.Auto`` axes (``tests/gspmd_reference.py``,
run once for the file): (data=2, model=2), (model=4), (pod=2,
data=2) and (pipe=2, data=2), two microbatches on (data=2, model=2), and ``seq_parallel`` on
(data=2, model=2) and (model=4), on the inputs of
``tests/test_torch_train.py::test_train_step_matches_jax`` (whose
bounds these are).  The dense function does not depend on the mesh, so
the f64 yardstick is the port's mesh-less step."""

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
}


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
    run_ranks(ranks.gspmd_steps, 4, str(d), "steps", cases,
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    port = torch.load(d / "steps.pt", weights_only=False)
    cfg64 = get_config(ARCH, reduced=True).replace(dtype="float64")
    _, exact = compute_grads(
        params_from_jax(ranks.unflat(gref.params_of(ref["model4"])), cfg64),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg64)
    return ref, port, {k: v.numpy() for k, v in ranks.flat(exact)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gspmd_step_matches_reference_sharded_step(runs, case):
    """One step from the reference's parameters (``DATA``;
    AdamW at b1 = 0, so that its first moment is the gradient): the
    loss within 1e-5 relative, each gradient leaf within 1e-5 plus twice
    the reference's own error against the f64 gradient, the grad-norm
    within 3e-4 relative plus twice its error, and the parameters after
    the step as those bounds allow (``gspmd_reference.hold_step``: the
    dense train step's bounds of ROADMAP §C)."""
    ref, port, exact = runs
    assert port[case]["mesh"] == eval(str(ref[case]["mesh"]))
    gref.hold_step(port[case], ref[case], exact, factor=2)
