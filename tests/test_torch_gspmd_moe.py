"""The port's GSPMD train step of reduced olmoe-1b-7b (the moe family:
attention heads over ``model``, experts dispatched by all-to-all) on the
CPU, over 4 gloo ranks (``tests/torch_gspmd_ranks.py``), held against
the reference's own ``make_train_step(mesh=...)`` on the same mesh shape
with ``AxisType.Auto`` axes (``tests/gspmd_reference.py``, run once for
the file).  With a ``model`` axis the reference routes each (batch,
sequence) block with its own capacity and drops the overflow
(``apply_moe_ep``), so the function depends on the mesh: the f64
yardstick is the port's own GSPMD step in f64 on the same mesh, and the
bounds are the moe rule of ROADMAP §C (``GEMM_FACTOR`` times the
reference's error)."""

import pytest
import torch

import gspmd_reference as gref
import torch_gspmd_ranks as ranks
from repro_torch.launch.mesh import run_ranks

RANK_DEADLINE_S = 240
ARCH = "olmoe-1b-7b"
GEMM_FACTOR = 3
# the moe train-step test's data (seq 32 x 4 of seed 5), its batch 0
DATA = dict(seq=32, batch=4, seed=5, first=0)

CASES = {
    "data2_model2": dict(mesh=dict(model=2)),
    "model4": dict(mesh=dict(model=4)),
    "pod2_data2": dict(mesh=dict(pods=2)),
    "data2_model2_sp": dict(mesh=dict(model=2),
                            cfg_kw=dict(seq_parallel=True)),
    "model4_micro2": dict(mesh=dict(model=4), micro=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    """The reference's step for every case and a mesh-less one, then the
    port's on 4 ranks from the reference's parameters, in f32 and f64,
    one world for the file."""
    d = tmp_path_factory.mktemp("gspmd_moe")
    ref = gref.run_reference(subproc, d, [
        dict(name=k, arch=ARCH, **DATA, **v) for k, v in CASES.items()])
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import make_data as jax_make_data
    batch = jax_make_data(jax_get_config(ARCH, reduced=True), DATA["seq"],
                          DATA["batch"], DATA["seed"]).batch_at(DATA["first"])
    cases = {}
    for k, v in CASES.items():
        case = dict(arch=ARCH, cfg_kw=v.get("cfg_kw", {}), mesh_kw=v["mesh"],
                    micro=v.get("micro", 1),
                    params=gref.params_of(ref[k]), batches=[batch])
        cases[k] = case
        cases[k + "_f64"] = dict(case, dtype="float64")
    run_ranks(ranks.gspmd_steps, 4, str(d), "steps", cases,
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    return ref, torch.load(d / "steps.pt", weights_only=False), batch


@pytest.mark.parametrize("case", sorted(CASES))
def test_gspmd_moe_step_matches_reference_sharded_step(runs, case):
    """One step from the reference's parameters (AdamW at b1 = 0): the
    loss within 1e-5 relative; each gradient within 1e-5 plus
    ``GEMM_FACTOR`` times the reference's error against the port's f64
    step on the same mesh, the grad-norm within 3e-4 relative plus
    ``GEMM_FACTOR`` times its error, the parameters after the step as
    those bounds allow (``gspmd_reference.hold_step``)."""
    ref, port, _ = runs
    assert port[case]["mesh"] == eval(str(ref[case]["mesh"]))
    gref.hold_step(port[case], ref[case], port[case + "_f64"]["mu"],
                   factor=GEMM_FACTOR)


def test_gspmd_moe_loss_depends_on_the_mesh(runs):
    """The expert-parallel function is the mesh's: with a ``model`` axis
    the reference's loss leaves the mesh-less one (its capacity drops
    differ by block), and the port's follows the reference's on every
    mesh; (pod=2, data=2), which has no ``model`` axis, keeps the dense
    layer's."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.train.step import loss_fn as jax_loss_fn
    ref, port, batch = runs
    jcfg = jax_get_config(ARCH, reduced=True)
    jparams = jax.tree.map(jax.numpy.asarray, ranks.unflat(
        gref.params_of(ref["model4"])))
    meshless = float(jax_loss_fn(jparams, batch, jcfg)[0])
    assert gref.close(ref["pod2_data2"]["loss0"], meshless, 1e-5)
    for case in ("data2_model2", "model4"):
        assert not gref.close(ref[case]["loss0"], meshless, 1e-3), case
        assert gref.close(port[case]["metrics"][0]["loss"],
                          ref[case]["loss0"], 1e-5), case
    print({k: float(v["loss0"]) for k, v in ref.items()}, meshless)
