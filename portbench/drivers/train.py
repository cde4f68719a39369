"""The ``train`` driver: the port's ``Trainer`` on the benchmark's
weights and batches.

Set-up builds one ``Trainer`` at the configuration's sizes (bf16, the
remat policy and everything else as the configuration file's ``port``
block sets them; no checkpoints), copies the weights drawn from the seed
into its state, and drives ``Trainer.train_step`` through the mix's
``setup_steps`` first steps, each on its own batch and ending in the
Trainer's own device sync (the ``float`` of its metrics).  Those steps
warm every shape, and they are what the reference follows: after the
first the program's optimizer state gives each leaf's gradient norm,
after the last each leaf's change from the drawn weights.  The same
object then runs the window: steps on the next batches until
``--seconds`` have passed.  After the window the peak memory is read,
the program is freed, and the reference runs the same first steps from
the same seed (:func:`portbench.reference.steps.follow`).

``ctx.fault`` plants a fault in the program for the tests:
``"unchanged"`` (the step returns the state it was given) or
``"half_batch"`` (half the rows left out, the loss their mean).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch
from torch.profiler import record_function

from portbench import check, counts, data, layout, weights
from portbench.harness import Record
from portbench.reference import steps as ref_steps
from portbench.trace import EmptyTrace, Trace

PROFILE_ATTEMPTS = 2    # a profile that comes back empty is taken again


def port_config(c: Dict):
    """The port's ``ModelConfig`` for configuration file ``c``: the
    registered architecture, its sizes from the file's keys, and the
    run's settings."""
    from repro_torch.configs import get_config
    port = c["port"]
    sizes = {key: c[src] for key, src in port["keys"].items()}
    return get_config(port["arch"]).replace(**sizes, **port["set"])


class Program:
    def __init__(self, ctx):
        from repro_torch.train import TrainConfig, Trainer
        c, mix, opt = ctx.config, ctx.mix, ctx.mix["optimizer"]
        self.ctx, self.cfg = ctx, port_config(c)
        self.dtype = getattr(torch, self.cfg.dtype)
        self.device = torch.device(ctx.device)
        tcfg = TrainConfig(steps=opt["total_steps"], seq_len=mix["seq_len"],
                           global_batch=mix["batch"], lr=opt["lr"],
                           warmup=opt["warmup"],
                           weight_decay=opt["weight_decay"], ckpt_dir=None,
                           seed=ctx.seed)
        self.trainer = Trainer(self.cfg, tcfg, device=self.device)
        self.leaves = layout.leaves(c)
        weights.load_into(self.trainer.state.params, self.leaves,
                          self.draw())

    def draw(self):
        return weights.draw(self.leaves, self.ctx.seed, self.dtype,
                            self.device)

    def step(self, k: int):
        """Step ``k`` on batch ``k``: (its metrics, seconds making and
        copying the batch)."""
        ctx, mix = self.ctx, self.ctx.mix
        with record_function("portbench.input"):
            t = time.perf_counter()
            b = data.batch_at(ctx.seed, k, mix["batch"], mix["seq_len"],
                              ctx.config["vocab_size"])
            if ctx.fault == "half_batch":
                b = {n: a[:mix["batch"] // 2] for n, a in b.items()}
            batch = {n: torch.from_numpy(a).to(self.device)
                     for n, a in b.items()}
            input_s = time.perf_counter() - t
        with record_function("portbench.step"):
            state, metrics = self.trainer.train_step(self.trainer.state,
                                                     batch)
            if ctx.fault != "unchanged":
                self.trainer.state = state
        with record_function("portbench.sync"):
            values = {n: float(v) for n, v in metrics.items()}   # waits
        return values, input_s

    def _norms(self, tree, leaf, minus=None):
        x = weights.leaf_of(tree, leaf)
        parts = x.unbind(0) if leaf.layers else [x]
        base = minus.unbind(0) if minus is not None and leaf.layers \
            else [minus] * len(parts)
        return [float(torch.linalg.vector_norm(
            p.float() if m is None else p.float() - m.float()))
            for p, m in zip(parts, base)]

    def first_steps(self, n: int) -> ref_steps.Readings:
        """Steps 0 .. n-1 and what the reference compares of them."""
        opt = self.ctx.mix["optimizer"]
        losses, grads = [], {}
        for k in range(n):
            values, _ = self.step(k)
            losses.append(values["loss"])
            if k == 0:
                clip = min(1.0, opt["max_grad_norm"]
                           / (values["grad_norm"] + 1e-12))
                mu = self.trainer.state.opt_state.mu
                for leaf in self.leaves:
                    grads.update(zip(layout.per_layer_names(leaf),
                                     (v / ((1 - opt["b1"]) * clip)
                                      for v in self._norms(mu, leaf))))
        start = self.draw()
        change = {}
        for leaf in self.leaves:
            change.update(zip(layout.per_layer_names(leaf),
                              self._norms(self.trainer.state.params, leaf,
                                          start[leaf.name])))
        del start
        return ref_steps.Readings(losses, grads, change)

    def window(self, first: int, seconds: float):
        """Steps from batch ``first`` on until ``seconds`` have passed:
        [(start, end, loss)], [input seconds]."""
        steps, inputs, k = [], [], first
        with record_function("portbench.window"):
            t0 = time.perf_counter()
            while not steps or time.perf_counter() - t0 < seconds:
                start = time.perf_counter()
                values, input_s = self.step(k)
                steps.append((start, time.perf_counter(), values["loss"]))
                inputs.append(input_s)
                k += 1
        return steps, inputs


def _profiled_window(prog: Program, first: int, seconds: float):
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            steps, inputs = prog.window(first, seconds)
        try:
            return steps, inputs, Trace(prof.events())
        except EmptyTrace as e:
            prog.ctx.log(f"profile attempt {attempt + 1}: {e}")
            first += len(steps)
    raise EmptyTrace(f"{PROFILE_ATTEMPTS} profiles of the window held no "
                     f"device activity")


def run(ctx) -> Record:
    c, mix = ctx.config, ctx.mix
    n_first = mix["setup_steps"]
    cuda = torch.device(ctx.device).type == "cuda"
    prog = Program(ctx)
    built = time.time()
    mine = prog.first_steps(n_first)
    setup_s = time.time() - ctx.started
    ctx.log(f"set-up {setup_s:.1f} s: the program and its weights at "
            f"{built - ctx.started:.1f} s, then {n_first} steps")
    trace = None
    if ctx.trace:
        steps, inputs, trace = _profiled_window(prog, n_first, ctx.seconds)
        ctx.log(f"trace read in {time.time() - ctx.started - setup_s:.1f} s "
                f"from the window's start")
    else:
        steps, inputs = prog.window(n_first, ctx.seconds)
    peak = torch.cuda.max_memory_allocated(prog.device) if cuda else None
    ctx.after_window()
    dtype, store = prog.cfg.dtype, prog.dtype
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = ref_steps.follow(c, mix, ctx.seed, ctx.device, n_first, store)
    ctx.log(f"reference: {n_first} steps in {time.perf_counter() - t:.1f} s;"
            f" losses {ref.losses}, the program's {mine.losses}; each "
            f"step's gap {check.loss_gaps(mine, ref)}")
    window_losses = [loss for _, _, loss in steps]
    ctx.log(f"window: {len(steps)} steps, losses from {min(window_losses)} "
            f"to {max(window_losses)}")
    checks = check.compare(mine, ref, ctx.limits)
    return Record(
        run=ctx, setup_s=setup_s, steps=[(a, b) for a, b, _ in steps],
        tokens_per_step=mix["batch"] * mix["seq_len"], input_s=inputs,
        model_flops_per_step=counts.model_flops(c, mix["seq_len"],
                                                mix["batch"]),
        dtype=dtype, peak_bytes=peak, trace=trace, checks=checks,
        attempted=len(steps),
        failed=sum(not math.isfinite(loss) for _, _, loss in steps))
