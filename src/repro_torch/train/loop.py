"""Training loop: data -> step -> metrics/checkpoints, with the
reference's fault-tolerance contract:

  * checkpoint every ``ckpt_every`` steps (async, atomic commit);
  * restart-from-LATEST on construction — a killed job resumes bitwise
    (deterministic data keyed by step + exact state restore);
  * failure injection (``fail_at_step``) for the FT tests;
  * straggler watermarks: per-step wall time + a hook that fires when a
    step exceeds ``straggler_factor``x the running median.

Runs on the card unless ``device="cpu"`` is given.  The reference's
pipeline (shard_map) step and ``mesh`` wait for ROADMAP A14.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_data
from repro_torch.models import for_config
from repro_torch.optim import adamw as adamw_fn
from repro_torch.optim import linear_warmup_cosine
from repro_torch.utils.device import resolve_device
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.utils.tree import tree_map


class InjectedFailure(RuntimeError):
    pass


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
        if mesh is not None:
            raise NotImplementedError("Trainer: mesh (the pipeline and "
                                      "sharded steps) is not ported yet; "
                                      "see ROADMAP A14 (distribution)")
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = resolve_device(device)
        self.data = make_data(cfg, tcfg.seq_len, tcfg.global_batch, tcfg.seed)
        sched = linear_warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.opt = adamw_fn(sched, weight_decay=tcfg.weight_decay,
                            max_grad_norm=1.0)
        self.straggler_hook = straggler_hook
        self.step_times: List[float] = []
        self.metrics_log: List[Dict] = []
        self._ckpt = checkpoint.AsyncCheckpointer()

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        params = for_config(cfg).init_model(cfg, gen)
        state = TrainState(params=params, opt_state=self.opt.init(params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=self.device))
        self.start_step = 0
        if tcfg.ckpt_dir and checkpoint.latest_step(tcfg.ckpt_dir) is not None:
            state, self.start_step = checkpoint.restore(tcfg.ckpt_dir, state)
            state = tree_map(lambda x: x.to(self.device), state)
        self.state = state
        self.train_step = make_train_step(
            cfg, self.opt, num_microbatches=tcfg.num_microbatches)

    def run(self) -> List[Dict]:
        t = self.tcfg
        try:
            return self._run()
        finally:
            # join the in-flight async write even on a crash path: a
            # checkpoint whose save() started is either fully committed or
            # absent — never torn.
            if t.ckpt_dir:
                self._ckpt.wait()

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
                self._ckpt.save(t.ckpt_dir, step + 1, self.state)
        if t.ckpt_dir:
            self._ckpt.wait()
            checkpoint.save(t.ckpt_dir, t.steps, self.state)
        return self.metrics_log
