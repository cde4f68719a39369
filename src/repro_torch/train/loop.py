"""Training loop: data -> step -> metrics/checkpoints, with the
reference's fault-tolerance contract:

  * checkpoint every ``ckpt_every`` steps (async, atomic commit);
  * restart-from-LATEST on construction — a killed job resumes bitwise
    (deterministic data keyed by step + exact state restore);
  * failure injection (``fail_at_step``) for the FT tests;
  * straggler watermarks: per-step wall time + a hook that fires when a
    step exceeds ``straggler_factor``x the running median.

Runs on the card unless ``device="cpu"`` is given.  A mesh
(:func:`repro_torch.launch.mesh.make_host_mesh`, on every rank) selects
the pipeline step (:func:`repro_torch.train.step.make_sharded_train_step`)
when it has a ``pipe`` axis >= 2, else the GSPMD step
(``make_train_step(mesh=...)``).  Each rank draws the parameters from
the seed on its device and keeps its own blocks, and checkpoints hold
the global layout (rank 0 writes the gathered state; a restore takes
each rank's blocks, ``checkpoint.restore(shardings=)``), so they resume
on any mesh, or none, whichever wrote them.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

import torch.distributed as dist

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_data
from repro_torch.dist import sharding as shd
from repro_torch.models import for_config
from repro_torch.optim import adamw as adamw_fn
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train.step import (TrainState, init_ef_state,
                                    make_sharded_train_step, make_train_step,
                                    sharded_state_specs, wants_ef)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


class InjectedFailure(RuntimeError):
    pass


def pipeline_microbatch_clamp(n_micro: int, global_batch: int, mesh):
    """``(clamped, per_shard_batch)``: the pipeline microbatch count the
    Trainer will actually stream — the requested count gcd-clamped to
    divide the per-shard batch.  One definition, shared by the Trainer
    (which applies it) and ``launch.train`` (which warns about it)."""
    local_b = max(1, global_batch // max(1, shd.dp_size(mesh)))
    return math.gcd(n_micro, local_b) or 1, local_b


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    num_microbatches: int = 1
    seed: int = 0
    fail_at_step: Optional[int] = None        # failure injection (tests)
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 straggler_hook: Optional[Callable[[int, float], None]] = None,
                 device=None):
        # a mesh with a pipe axis >= 2 selects the pipeline step: gpipe or
        # 1f1b microbatches over `pipe`, compressed psum over `pod`; any
        # other mesh the GSPMD step
        self.use_pipeline = mesh is not None and shd.pipe_size(mesh) > 1
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        # rank 0 prints and writes checkpoints
        self.is_main = mesh is None or mesh.rank == 0
        self.data = make_data(cfg, tcfg.seq_len, tcfg.global_batch, tcfg.seed)
        sched = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.opt = adamw_fn(sched, weight_decay=tcfg.weight_decay,
                            max_grad_norm=1.0)
        self.straggler_hook = straggler_hook
        self.step_times: List[float] = []
        self.metrics_log: List[Dict] = []
        self._ckpt = checkpoint.AsyncCheckpointer()

        model = for_config(cfg)
        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        params = model.init_model(cfg, gen)
        self.specs = None
        if mesh is not None:
            # every rank draws the same parameters from the seed on its
            # device and keeps its own blocks
            self.specs = sharded_state_specs(cfg, mesh, wants_ef(cfg, mesh))
            params = shd.shard_tree(params, self.specs.params, mesh)
        state = TrainState(params=params, opt_state=self.opt.init(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=self.device))
        if self.use_pipeline and wants_ef(cfg, mesh):
            # error-feedback residuals ride in the train state so they are
            # checkpointed (a restart must not reset them)
            state = state._replace(
                ef=init_ef_state(params, mesh,
                                 spec_tree=model.model_spec(cfg)))

        self.start_step = 0
        if tcfg.ckpt_dir and checkpoint.latest_step(tcfg.ckpt_dir) is not None:
            state, self.start_step = self._restore(state)
        self.state = state

        if self.use_pipeline:
            if tcfg.num_microbatches > 1 and self.is_main:
                # the pipeline step has no gradient-accumulation loop; its
                # microbatches are the pipeline stream
                print(f"[train] pipeline step ignores num_microbatches="
                      f"{tcfg.num_microbatches} (no gradient accumulation; "
                      f"gpipe streams cfg.pipeline_microbatches instead)")
            # clamp the pipeline microbatch count to divide the per-shard
            # batch (strictness stays in make_sharded_train_step for
            # direct callers)
            n_micro, local_b = pipeline_microbatch_clamp(
                cfg.pipeline_microbatches, tcfg.global_batch, mesh)
            if n_micro != cfg.pipeline_microbatches and self.is_main:
                print(f"[train] pipeline microbatches clamped "
                      f"{cfg.pipeline_microbatches} -> {n_micro} "
                      f"(per-shard batch {local_b})")
            self.train_step = make_sharded_train_step(
                cfg, self.opt, mesh, num_microbatches=n_micro)
        else:
            self.train_step = make_train_step(
                cfg, self.opt, mesh=mesh,
                num_microbatches=tcfg.num_microbatches)

    def _restore(self, state):
        """The reference's three restore cases: a checkpoint that matches;
        one with no error-feedback residuals where the run wants them
        (restore the rest, restart ef at zero); one that does not match."""
        like, specs = state, self.specs
        if self.mesh is not None:
            # the global shapes alone: restore reads shapes and structure
            like = tree_map(lambda x, s: torch.empty(
                shd.global_shape(x.shape, s, self.mesh), dtype=x.dtype,
                device="meta"), state, specs)
        try:
            restored, start = checkpoint.restore(
                self.tcfg.ckpt_dir, like, shardings=self._shardings(specs))
        except (ValueError, TypeError) as e:
            if state.ef is None:
                # template has no ef leaves but restore still failed —
                # most likely a checkpoint from a compressed multi-pod run
                # resumed under a different compress/mesh config
                raise RuntimeError(
                    "checkpoint restore failed: if the checkpoint was "
                    "written by a compressed multi-pod run (TrainState"
                    ".ef present), restart with the same "
                    "compress_pod_grads / mesh configuration") from e
            # checkpoint predates the compressed-reduction config (no ef
            # leaves): restore everything else and restart the
            # error-feedback residuals from zero
            if specs is not None:
                specs = specs._replace(ef=None)
            restored, start = checkpoint.restore(
                self.tcfg.ckpt_dir, like._replace(ef=None),
                shardings=self._shardings(specs))
            if self.is_main:
                print("[train] checkpoint carries no error-feedback "
                      "residuals; reinitialized ef to zero")
            ef = state.ef
        else:
            ef = None
        restored = tree_map(lambda x: x.to(self.device), restored)
        if ef is not None:
            restored = restored._replace(ef=ef)
        return restored, start

    def _shardings(self, specs):
        return (None if specs is None
                else shd.named_shardings(specs, self.mesh))

    def _save(self, step: int, blocking: bool = False) -> None:
        """Checkpoint the state in its global layout: a run on a mesh
        gathers it from the ranks (a collective) and rank 0 writes it."""
        tree = (shd.gather_tree(self.state, self.specs, self.mesh)
                if self.mesh is not None else self.state)
        if self.is_main:
            if blocking:
                checkpoint.save(self.tcfg.ckpt_dir, step, tree)
            else:
                self._ckpt.save(self.tcfg.ckpt_dir, step, tree)

    def run(self) -> List[Dict]:
        t = self.tcfg
        try:
            return self._run()
        finally:
            # join the in-flight async write even on a crash path: a
            # checkpoint whose save() started is either fully committed or
            # absent — never torn.  Ranks wait for rank 0's writes, so
            # that a restart on any rank finds the same LATEST.
            if t.ckpt_dir:
                self._ckpt.wait()
                if self.mesh is not None:
                    dist.barrier()

    def _run(self) -> List[Dict]:
        t = self.tcfg
        for step in range(self.start_step, t.steps):
            if t.fail_at_step is not None and step == t.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
            t0 = time.time()
            self.state, metrics = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits
            dt = time.time() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-50:])
                if dt > self.tcfg.straggler_factor * med \
                        and self.straggler_hook is not None:
                    self.straggler_hook(step, dt)
            metrics.update(step=step, seconds=dt)
            self.metrics_log.append(metrics)
            if t.ckpt_dir and (step + 1) % t.ckpt_every == 0:
                self._save(step + 1)
        if t.ckpt_dir:
            self._ckpt.wait()
            self._save(t.steps, blocking=True)
        return self.metrics_log
