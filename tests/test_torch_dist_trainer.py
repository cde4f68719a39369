"""The port's pipeline ``Trainer`` and its checkpoints across layouts,
and ``launch.train`` under ``torchrun``, on the CPU.

A pipeline run writes the global layout (rank 0 saves the gathered
state), so its checkpoints resume under another mesh, in a mesh-less
run, and in the reference's ``checkpoint.restore``; a mesh-less
checkpoint resumes in a pipeline run.  ``launch.train`` with
``--model``/``--pods`` and no ``--pipe`` trains with the GSPMD step.  The
ranks run
``tests/torch_dist_ranks.py::checkpoint_layouts`` in one world of 4
(``repro_torch.launch.mesh.run_ranks``, a ``file://`` rendezvous under
``tmp_path``, a deadline of ``RANK_DEADLINE_S``)."""

import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.train import TrainConfig, Trainer

RANK_DEADLINE_S = 240
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TCFG = dict(steps=6, ckpt_every=2, seq_len=16, global_batch=4, lr=1e-3,
            warmup=2)


def _cfg(get):
    return get("stablelm-3b", reduced=True).replace(n_layers=4,
                                                   pipeline_microbatches=2)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layouts")
    meshless = str(tmp / "meshless")
    Trainer(_cfg(get_config), TrainConfig(ckpt_dir=meshless, **TCFG),
            device="cpu").run()
    run_ranks(ranks.checkpoint_layouts, 4, str(tmp), str(tmp), meshless,
              TCFG, init_method=f"file://{tmp}/pg", timeout_s=RANK_DEADLINE_S)
    return tmp, torch.load(tmp / "checkpoint_layouts.pt", weights_only=False)


def test_pipeline_trainer_kills_and_resumes(layouts):
    """(pipe=2, model=2): killed at step 5 after the step-4 checkpoint,
    the resumed run starts at 4 and replays the uninterrupted run's losses
    (``tests/test_data_ckpt_ft.py``'s rel 1e-5)."""
    _, out = layouts
    steps = TCFG["steps"]
    start, losses = out["killed"]
    assert start == 0 and sorted(losses) == list(range(steps - 1))
    start, losses, _ = out["resumed"]
    assert start == steps - 2 and sorted(losses) == [steps - 2, steps - 1]
    for step, loss in losses.items():
        assert loss == pytest.approx(out["plain"][step], rel=1e-5), step


def test_meshless_trainer_resumes_pipeline_checkpoint(layouts):
    """A mesh-less port ``Trainer`` restores the pipeline run's last
    checkpoint with the same parameters, bit for bit."""
    tmp, out = layouts
    trainer = Trainer(_cfg(get_config), TrainConfig(
        ckpt_dir=str(tmp / "finished"), **dict(TCFG, steps=TCFG["steps"] + 1)),
        device="cpu")
    assert trainer.start_step == TCFG["steps"]
    params = dict(_flat(trainer.state.params))
    assert sorted(params) == sorted(out["resumed"][2])
    for path, p in out["resumed"][2].items():
        assert torch.equal(params[path], p), path


def test_reference_restores_pipeline_checkpoint(layouts):
    """The reference's ``checkpoint.restore`` reads the pipeline run's
    checkpoint into its own ``TrainState`` layout, bit for bit."""
    tmp, out = layouts
    like = JaxTrainer(_cfg(jax_get_config), JaxTrainConfig(**TCFG)).state
    state, step = jckpt.restore(str(tmp / "finished"), like)
    assert step == TCFG["steps"]
    for path, p in _flat(jax.tree.map(np.asarray, state.params)):
        np.testing.assert_array_equal(p, out["resumed"][2][path].numpy())


def test_restore_cases_across_residuals(layouts):
    """The reference's three restore cases: a (pod=2, pipe=2) run resumes
    a checkpoint with no error-feedback residuals, restarting them at zero
    with the reference's notice; its own checkpoint then carries them
    (global (pod, *param)), and a mesh-less run, which has none, refuses
    it with the reference's message."""
    tmp, out = layouts
    start, losses, said, ef_shapes = out["pods"]
    assert start == TCFG["steps"]
    assert sorted(losses) == [TCFG["steps"], TCFG["steps"] + 1]
    assert "[train] checkpoint carries no error-feedback residuals; " \
        "reinitialized ef to zero" in said
    params = dict(_flat(Trainer(_cfg(get_config), TrainConfig(**TCFG),
                                device="cpu").state.params))
    for path, shape in ef_shapes.items():
        assert shape == (2,) + tuple(params[path].shape)
    with pytest.raises(RuntimeError, match="compressed multi-pod run"):
        Trainer(_cfg(get_config), TrainConfig(ckpt_dir=str(tmp / "killed"),
                                              **TCFG), device="cpu")


def test_pipeline_trainer_resumes_meshless_checkpoint(tmp_path, layouts):
    """A mesh-less run's checkpoint resumes in a (pipe=2, model=2) run,
    whose next loss equals the mesh-less run's own continuation within
    1e-4 relative (``tests/test_dist.py``'s pipeline-vs-plain bound)."""
    _, out = layouts
    start, losses = out["from_meshless"]
    assert start == TCFG["steps"] and sorted(losses) == [TCFG["steps"]]
    meshless = str(tmp_path / "meshless")
    Trainer(_cfg(get_config), TrainConfig(ckpt_dir=meshless, **TCFG),
            device="cpu").run()
    log = Trainer(_cfg(get_config), TrainConfig(
        ckpt_dir=meshless, **dict(TCFG, steps=TCFG["steps"] + 1)),
        device="cpu").run()
    assert log[0]["step"] == TCFG["steps"]
    assert losses[TCFG["steps"]] == pytest.approx(log[0]["loss"], rel=1e-4)


_REF_LAUNCH = ["-m", "repro.launch.train", "--pipe", "2", "--model", "2",
               "--steps", "1", "--seq-len", "16", "--global-batch", "4"]


def _torchrun(flags, env):
    """rank 0's output of ``torchrun --standalone --nproc-per-node 4 -m
    repro_torch.launch.train --device cpu`` with ``flags``, 2 steps of
    seq 16 x 4 (it must exit 0)."""
    # torchrun in a session of its own: at the deadline the whole group,
    # its ranks included, is killed
    port = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", *flags, "--steps", "2", "--seq-len", "16",
         "--global-batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        out, err = port.communicate(timeout=RANK_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(port.pid, signal.SIGKILL)
        port.communicate()
        raise
    assert port.returncode == 0, out[-3000:] + err[-3000:]
    return out


def test_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --device
    cpu --pipe 2 --model 2`` (reduced stablelm-3b, 2 steps) prints the
    reference launcher's ``[train] mesh:`` line (the reference run on 4
    host devices), names its backend, and only rank 0 prints step
    lines."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.run(
        [sys.executable, *_REF_LAUNCH], capture_output=True, text=True,
        timeout=300, env=dict(env, XLA_FLAGS="--xla_force_host_platform_"
                                             "device_count=4"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = re.search(r"^\[train\] mesh: .*$", ref.stdout, re.M).group(0)
    out = _torchrun(["--pipe", "2", "--model", "2"], env)
    lines = out.splitlines()
    assert want in lines, (want, out)
    assert any("backend gloo" in ln for ln in lines)
    assert sum(ln.startswith("[train] step=") for ln in lines) == 2
    assert sum(ln.startswith("[train] final loss") for ln in lines) == 1


GSPMD_FLAGS = {"data2_model2": ["--model", "2"],
               "pod2_data2": ["--pods", "2"]}


def test_launcher_refuses_the_gspmd_mesh(tmp_path, subproc):
    """``--model 2`` and ``--pods 2`` without ``--pipe`` (no longer
    refused) train with the GSPMD step under ``torchrun`` (4 ranks, the
    CPU): rank 0 prints the mesh the reference's ``host_mesh_shape``
    gives, the note that ``--pods`` without a pipe axis reduces in f32,
    and 2 step lines whose losses (printed to 4 decimals) lie within
    1e-5 relative (step 0) and 1e-4 (step 1, after an update) of the
    reference's ``make_train_step(mesh=...)`` on that mesh shape from the
    launcher's initial parameters, optimizer and data
    (``gspmd_reference.trainer_reference``)."""
    import gspmd_reference as gref
    from repro.launch.mesh import host_mesh_shape
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    meshes = {"data2_model2": dict(model=2), "pod2_data2": dict(pods=2)}
    ref = gref.trainer_reference(
        subproc, tmp_path, dict(steps=2, seq_len=16, global_batch=4),
        ["stablelm-3b"], meshes)
    for label, flags in GSPMD_FLAGS.items():
        out = _torchrun(flags, env)
        shape, names = host_mesh_shape(4, **meshes[label])
        want = f"[train] mesh: {dict(zip(names, shape))}"
        lines = out.splitlines()
        assert any(ln.startswith(want) for ln in lines), (want, out)
        assert ("fp32 psum" in out) == (label == "pod2_data2"), out
        losses = [float(re.search(r"loss=(\S+)", ln).group(1))
                  for ln in lines if ln.startswith("[train] step=")]
        r = ref[f"stablelm-3b_{label}"]
        assert len(losses) == 2, out
        assert gref.close(losses[0], r["loss0"], 1e-5), (losses, r["loss0"])
        assert gref.close(losses[1], r["loss1"], 1e-4), (losses, r["loss1"])
