"""Rank bodies of the port's distributed tests (``tests/test_torch_dist*.py``).

Each function runs in one process of a world that
``repro_torch.launch.mesh.run_ranks`` spawns on the CPU (gloo), and
writes what it measured under ``out_dir`` for the test to check.  This
module imports torch and the port only, so that the spawned ranks load
no jax."""

import os

import numpy as np
import torch


def _save(out_dir, name, obj):
    path = os.path.join(out_dir, name)
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def abort_at_exit(rank, out_dir):
    """Write this rank's result, then arm an abort for the interpreter's
    teardown."""
    import atexit
    _save(out_dir, f"done_{rank}.pt", rank)
    atexit.register(os.abort)


def collectives(rank, out_dir):
    """psum over ``model``, over (``pipe``, ``model``), pmean over
    ``pipe``, and a ring ppermute over ``pipe`` on a (pipe=2, model=2)
    mesh: each rank's input and loss weight are drawn from its rank, and
    the rank saves its forward outputs and its input's gradient."""
    from repro_torch.dist import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(pipe=2, model=2, device="cpu")
    out = {"coords": mesh.coords, "repr": repr(mesh)}
    pipe, model = mesh.axis("pipe"), mesh.axis("model")
    cases = {"psum_model": lambda x: col.psum(x, model),
             "psum_both": lambda x: col.psum(x, (pipe, model)),
             "pmean_pipe": lambda x: col.pmean(x, pipe),
             "ring_pipe": lambda x: col.ppermute(x, pipe, [(0, 1), (1, 0)]),
             "shift_model": lambda x: col.ppermute(x, model, [(0, 1)])}
    for name, fn in cases.items():
        gen = np.random.default_rng(rank)
        x = torch.from_numpy(gen.standard_normal((3, 5)).astype(np.float32))
        c = torch.from_numpy(gen.standard_normal((3, 5)).astype(np.float32))
        x.requires_grad_()
        y = fn(x)
        (g,) = torch.autograd.grad((c * y).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    out["axis_index"] = (col.axis_index(mesh, "pipe"),
                         col.axis_index(mesh, "model"))
    _save(out_dir, f"collectives_{rank}.pt", out)


def pipelined(rank, out_dir, ws, xs):
    """The reference's gpipe test for the port: S = 4 stages of
    ``tanh(x @ w)`` over a (pipe=4) mesh, by ``gpipe`` and by the 1f1b
    schedule's ``run``."""
    from repro_torch.dist.pipeline import OneFOneBSchedule, gpipe
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(pipe=4, device="cpu")

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    ws, xs = torch.from_numpy(ws), torch.from_numpy(xs)
    out = {"gpipe": gpipe(stage_fn, ws, xs, mesh).numpy(),
           "1f1b": OneFOneBSchedule().run(stage_fn, ws, xs, mesh).numpy()}
    _save(out_dir, f"pipelined_{rank}.pt", out)


def compressed(rank, out_dir, g_global, err0, steps):
    """``compressed_psum`` of rank ``rank``'s row of ``g_global`` over a
    ``pod`` axis of the world's size, ``steps`` times from the residual
    ``err0[rank]``; saves each step's mean and residual."""
    from repro_torch.dist.compress import compressed_psum
    from repro_torch.launch.mesh import make_host_mesh
    import torch.distributed as dist
    mesh = make_host_mesh(pods=dist.get_world_size(), device="cpu")
    pod = mesh.axis("pod")
    g = {"w": torch.from_numpy(g_global[rank:rank + 1])}
    err = {"w": torch.from_numpy(err0[rank:rank + 1])}
    avgs, errs = [], []
    for _ in range(steps):
        avg, err = compressed_psum(g, err, pod)
        avgs.append(avg["w"].numpy().copy())
        errs.append(err["w"].numpy().copy())
    _save(out_dir, f"compressed_{rank}.pt", {"avg": avgs, "err": errs})


# ---------------------------------------------------------------------------
# the pipeline train step
# ---------------------------------------------------------------------------

def _optimizer(kind):
    from repro_torch import optim
    if kind == "grads":
        # b1 = 0 and no clipping: after one step the first moment is the
        # assembled gradient, exactly
        return optim.adamw(optim.constant_schedule(1e-3), b1=0.0,
                           weight_decay=0.1)
    return optim.adamw(optim.constant_schedule(1e-3), weight_decay=0.1,
                       max_grad_norm=1.0)


def sharded_steps(rank, out_dir, name, cfg_kw, mesh_kw, params_np, batches,
                  runs, opt_kind, arch="stablelm-3b"):
    """Run the pipeline step of each of ``runs`` (``{label: keyword
    arguments of make_sharded_train_step}``) over ``batches`` from the
    same global parameters (numpy, the reference's layout) of reduced
    ``arch``, each from a fresh state.  Rank 0 saves every run's metrics, the gathered first
    moments and parameters, the residuals' L1 and how often
    ``compressed_psum`` ran."""
    from repro_torch.configs import get_config
    from repro_torch.dist import compress
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train.step import (TrainState, init_ef_state,
                                        make_sharded_train_step,
                                        sharded_state_specs, wants_ef)
    calls = []
    orig = compress.compressed_psum

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    compress.compressed_psum = counted

    cfg = get_config(arch, reduced=True).replace(**cfg_kw)
    mesh = make_host_mesh(device="cpu", **mesh_kw)
    opt = _optimizer(opt_kind)
    results = {"mesh": dict(mesh.shape), "repr": repr(mesh)}
    for label, kw in runs.items():
        calls.clear()
        compress_pod = kw.get("compress_pod", cfg.compress_pod_grads)
        ef = compress_pod and wants_ef(cfg, mesh)
        specs = sharded_state_specs(cfg, mesh, ef)
        params = shd.shard_tree(params_from_jax(params_np, cfg),
                                specs.params, mesh)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32),
                           init_ef_state(params, mesh, lm.model_spec(cfg))
                           if ef else None)
        step = make_sharded_train_step(cfg, opt, mesh, **kw)
        metrics = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        g = shd.gather_tree(state, specs, mesh)
        results[label] = {
            "metrics": metrics,
            "mu": {k: v.numpy() for k, v in _flat(g.opt_state.mu)},
            "params": {k: v.numpy() for k, v in _flat(g.params)},
            "ef_l1": (None if g.ef is None else
                      sum(float(x.abs().sum()) for _, x in _flat(g.ef))),
            "ef_shapes": (None if g.ef is None else
                          {k: tuple(x.shape) for k, x in _flat(g.ef)}),
            "compressed_calls": len(calls)}
    if rank == 0:
        _save(out_dir, f"{name}.pt", results)


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the Trainer and its checkpoints
# ---------------------------------------------------------------------------

def _trainer(mesh_kw, ckpt_dir, fail_at_step=None, **tcfg_kw):
    """A pipeline ``Trainer`` of reduced stablelm-3b (4 layers) on the
    CPU; with ``fail_at_step`` it is killed there (``InjectedFailure``,
    on every rank).  Returns (start step, {step: loss}, rank 0's stdout,
    the gathered global state)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import InjectedFailure, TrainConfig, Trainer
    cfg = get_config("stablelm-3b", reduced=True).replace(
        n_layers=4, pipeline_microbatches=2)
    mesh = make_host_mesh(device="cpu", **mesh_kw)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        trainer = Trainer(cfg, TrainConfig(ckpt_dir=ckpt_dir,
                                           fail_at_step=fail_at_step,
                                           **tcfg_kw), mesh=mesh)
        try:
            log = trainer.run()
        except InjectedFailure:
            log = trainer.metrics_log
    state = shd.gather_tree(trainer.state, trainer.specs, mesh)
    return (trainer.start_step, {r["step"]: r["loss"] for r in log},
            said.getvalue(), state)


def checkpoint_layouts(rank, out_dir, run_dir, meshless_dir, tcfg_kw):
    """The pipeline ``Trainer``'s checkpoints, in phases on one world of 4:
    (pipe=2, model=2) uninterrupted; the same killed after a checkpoint
    and resumed from it; a (pod=2, pipe=2) run resuming that checkpoint,
    which carries no error-feedback residuals; and a (pipe=2, model=2)
    run resuming ``meshless_dir``, a mesh-less ``Trainer``'s checkpoint.
    Rank 0 saves what each phase saw."""
    import shutil

    import torch.distributed as dist
    pm = dict(pipe=2, model=2)
    out = {}
    steps = tcfg_kw["steps"]
    out["plain"] = _trainer(pm, None, **tcfg_kw)[1]
    killed = os.path.join(run_dir, "killed")
    out["killed"] = _trainer(pm, killed, fail_at_step=steps - 1,
                             **tcfg_kw)[:2]
    start, losses, _, state = _trainer(pm, killed, **tcfg_kw)
    out["resumed"] = (start, losses,
                      {k: v.clone() for k, v in _flat(state.params)})
    if rank == 0:
        # a copy of the finished run's checkpoints, before the pod run
        # below adds one with residuals
        shutil.copytree(killed, os.path.join(run_dir, "finished"))
    dist.barrier()
    kw = dict(tcfg_kw, steps=steps + 2)
    start, losses, said, state = _trainer(dict(pipe=2, pods=2), killed, **kw)
    out["pods"] = (start, losses, said,
                   {k: tuple(v.shape) for k, v in _flat(state.ef)})
    start, losses, _, _ = _trainer(pm, meshless_dir,
                                   **dict(tcfg_kw, steps=steps + 1))
    out["from_meshless"] = (start, losses)
    if rank == 0:
        _save(out_dir, "checkpoint_layouts.pt", out)
