"""The GSPMD ``Trainer`` and ``checkpoint.restore(shardings=)`` on the
CPU, over 4 gloo ranks (``tests/torch_gspmd_ranks.py::trainer_runs``,
one world for the file).

The ``Trainer`` of reduced stablelm-3b and olmoe-1b-7b on (data=2,
model=2) and (pod=2, data=2) for 2 steps, its losses held against the
reference's ``make_train_step(mesh=...)`` on an ``AxisType.Auto`` mesh
of the same shape (``tests/gspmd_reference.py``) driven with the
``Trainer``'s optimizer and data from the port ``Trainer``'s initial
parameters.  Checkpoints keep the global layout, so they move between
mesh-less and GSPMD runs: the counterpart of
``tests/test_data_ckpt_ft.py::test_elastic_restore_reshards``."""

import numpy as np
import pytest
import torch

import gspmd_reference as gref
import torch_gspmd_ranks as ranks
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.train import TrainConfig, Trainer

RANK_DEADLINE_S = 300
TCFG = dict(steps=2, seq_len=16, global_batch=4)
ARCHS = ("stablelm-3b", "olmoe-1b-7b")
MESHES = {"data2_model2": dict(model=2), "pod2_data2": dict(pods=2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("gspmd_trainer")
    cfg = get_config("stablelm-3b", reduced=True)
    Trainer(cfg, TrainConfig(ckpt_dir=str(d / "meshless"), **TCFG),
            device="cpu").run()
    run_ranks(ranks.trainer_runs, 4, str(d), str(d), TCFG,
              init_method=f"file://{d}/pg", timeout_s=RANK_DEADLINE_S)
    return d, torch.load(d / "trainer_runs.pt", weights_only=False), \
        gref.trainer_reference(subproc, d, TCFG, ARCHS, MESHES)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gspmd_trainer_matches_reference(runs, arch, mesh):
    """Step 0's loss within 1e-5 relative of the reference's, step 1's
    (after one AdamW update) within 1e-4 (the pipeline step's multi-step
    bound against the mesh-less step)."""
    _, port, ref = runs
    losses, want = port[(arch, mesh)], ref[f"{arch}_{mesh}"]
    assert gref.close(losses[0], want["loss0"], 1e-5), (losses, want["loss0"])
    assert gref.close(losses[1], want["loss1"], 1e-4), (losses, want["loss1"])


def test_restore_shardings_reshards_a_meshless_checkpoint(runs):
    """A mesh-less ``Trainer``'s checkpoint restored by
    ``restore(shardings=)`` on (data=2, model=2): the blocks gathered
    back equal the checkpoint's parameters bit for bit, and a GSPMD
    ``Trainer`` resumes from it at its step."""
    d, port, _ = runs
    step, got = port["restored"]
    cfg = get_config("stablelm-3b", reduced=True)
    like = Trainer(cfg, TrainConfig(**TCFG), device="cpu").state
    # the resumed GSPMD run below wrote a later step into the same dir
    want, wstep = checkpoint.restore(str(d / "meshless"), like,
                                     step=TCFG["steps"])
    assert step == wstep == TCFG["steps"]
    assert sorted(got) == sorted(k for k, _ in ranks.flat(want.params))
    for k, v in ranks.flat(want.params):
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert port["resumed"] == (TCFG["steps"], [TCFG["steps"]])


def test_gspmd_checkpoint_resumes_meshless(runs):
    """A GSPMD ``Trainer``'s checkpoint (rank 0 writes the gathered
    global state) restores mesh-less bit-equal to the ranks' gathered
    state, and a mesh-less ``Trainer`` resumes from it."""
    d, port, _ = runs
    cfg = get_config("stablelm-3b", reduced=True)
    like = Trainer(cfg, TrainConfig(**TCFG), device="cpu").state
    got, step = checkpoint.restore(str(d / "gspmd"), like)
    assert step == TCFG["steps"]
    for k, v in ranks.flat(got.params):
        np.testing.assert_array_equal(v.numpy(), port["gspmd_state"][k],
                                      err_msg=k)
    resumed = Trainer(cfg, TrainConfig(ckpt_dir=str(d / "gspmd"),
                                       **dict(TCFG, steps=TCFG["steps"] + 1)),
                      device="cpu")
    assert resumed.start_step == TCFG["steps"]
    assert [r["step"] for r in resumed.run()] == [TCFG["steps"]]
