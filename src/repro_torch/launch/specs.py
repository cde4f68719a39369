"""Dry-run cells and the schedule optimizer's kernel-fleet workload points.

The lowerable half (port of ``repro/launch/specs.py:34-168``):
``lowerable(cfg, shape_name, mesh)`` returns ``(fn, args)`` such that
``fn(*args)`` is the step of one rank that the dry run
(:mod:`repro_torch.launch.dryrun`) counts: ``args`` are this rank's
blocks, built as fake tensors when called inside ``FakeTensorMode``
(the reference's ``ShapeDtypeStruct``s with their shardings), so no
memory is allocated anywhere.

Kinds:
  train_4k     -> train_step(state, batch)
  prefill_32k  -> prefill(params, batch) -> logits
  decode_32k / long_500k -> serve_step(params, caches, token, pos)

The fleet half (``kernel_fleet_names``, ``shape_scenario``,
``fleet_scenarios``, ``kernel_fleet``) is the reference's, over the
port's ``configs/base.py::SHAPES``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw as adamw_fn, constant_schedule
from repro_torch.sched.scenario import Scenario
from repro_torch.serve import decode as serve_decode
from repro_torch.train.step import (PipelineStepError, TrainState,
                                    init_ef_state, make_sharded_train_step,
                                    make_train_step, sharded_state_specs,
                                    wants_ef)


def _model(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def params_fake(cfg: ModelConfig, mesh=None) -> Tuple[Dict, Optional[Dict]]:
    """(this rank's parameter blocks, their :class:`P` specs): the model's
    parameters made by ``init_model`` (seed 0; fake tensors inside
    ``FakeTensorMode``) and cut by ``param_shardings``.  Without a mesh,
    the whole parameters and None."""
    model = _model(cfg)
    params = model.init_model(cfg, torch.Generator().manual_seed(0))
    if mesh is None:
        return params, None
    specs = shd.param_shardings(model.model_spec(cfg), mesh)
    return shd.shard_tree(params, specs, mesh), specs


def _batch_fake(cfg: ModelConfig, seq: int, batch: int,
                with_labels: bool = True) -> Dict:
    """The global batch (the GSPMD step cuts each rank's block itself):
    tokens (and labels), and whisper's stub ``frames`` in bf16."""
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32)}
    if with_labels:
        out["labels"] = torch.zeros((batch, seq), dtype=torch.int32)
    if cfg.frontend == "audio_frames":
        out["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                    dtype=torch.bfloat16)
    return out


def _lower_opt():
    return adamw_fn(constant_schedule(3e-4), weight_decay=0.1,
                    max_grad_norm=1.0)


def _state(params, opt) -> TrainState:
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def sharded_train_lowerable(cfg: ModelConfig, mesh, *, seq: int,
                            batch: int, num_microbatches: int = None):
    """(fn, args) for the pipeline train step on ``mesh`` — the
    ``pipe``-axis analogue of the ``train`` branch of :func:`lowerable`
    (requires ``pipe >= 2``; raises ``PipelineStepError`` where the
    step cannot stage the config, see
    ``train.step.make_sharded_train_step``)."""
    step_fn = make_sharded_train_step(cfg, _lower_opt(), mesh,
                                      num_microbatches=num_microbatches)
    ef = wants_ef(cfg, mesh)
    specs = sharded_state_specs(cfg, mesh, ef)
    params = shd.shard_tree(
        lm.init_model(cfg, torch.Generator().manual_seed(0)),
        specs.params, mesh)
    state = _state(params, _lower_opt())
    if ef:
        state = state._replace(ef=init_ef_state(params, mesh,
                                                lm.model_spec(cfg)))
    return step_fn, (state, _batch_fake(cfg, seq, batch))


def cell(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh=None):
    """(fn, args) of one step of ``kind`` (train, prefill or decode) at
    ``seq`` x ``batch`` on ``mesh``, or without one (the whole model on
    one process): the body of :func:`lowerable`, at any shape."""
    if kind == "train" and mesh is not None and shd.pipe_size(mesh) > 1:
        try:
            return sharded_train_lowerable(cfg, mesh, seq=seq, batch=batch)
        except PipelineStepError:
            # arch/mesh not stage-uniform (encdec/hybrid families, leading
            # dense MoE layers, layers not divisible by pipe): the GSPMD
            # step below still runs — it simply ignores the pipe axis — so
            # an all-arch sweep over a pipe mesh keeps going
            pass

    params, _ = params_fake(cfg, mesh)
    if kind == "train":
        step_fn = make_train_step(cfg, _lower_opt(), mesh=mesh,
                                  num_microbatches=cfg.train_microbatches)
        return step_fn, (_state(params, _lower_opt()),
                         _batch_fake(cfg, seq, batch))

    if kind == "prefill":
        batch_in = _batch_fake(cfg, seq, batch, with_labels=False)
        if mesh is not None:
            batch_in = {k: shd.shard_leaf(v, shd.batch_spec(mesh, batch,
                                                            v.ndim), mesh)
                        for k, v in batch_in.items()}
        if cfg.family == "encdec":
            def prefill(params, batch):
                return encdec.forward(params, batch["frames"],
                                      batch["tokens"], cfg, mesh=mesh)
        else:
            def prefill(params, batch):
                return lm.forward(params, batch["tokens"], cfg, mesh=mesh)
        return prefill, (params, batch_in)

    # decode kinds: one new token against a cache of length `seq`
    caches = serve_decode.init_caches(cfg, batch, seq, "cpu")
    token = torch.zeros((batch, 1), dtype=torch.int32)
    c_specs = None
    if mesh is not None:
        c_specs = shd.decode_cache_shardings(cfg, caches, mesh)
        caches = shd.shard_tree(caches, c_specs, mesh)
        token = shd.shard_leaf(token, shd.batch_spec(mesh, batch), mesh)

    def serve_step(params, caches, token, pos):
        return serve_decode.decode_step(params, caches, token, pos, cfg,
                                        mesh=mesh, specs=c_specs)
    # pos a Python int: every row decodes position seq - 1
    return serve_step, (params, caches, token, seq - 1)


def lowerable(cfg: ModelConfig, shape_name: str, mesh):
    """-> (fn, args tuple): ``fn(*args)`` is the cell's step on this
    rank (see the module docstring)."""
    seq, batch, kind = SHAPES[shape_name]
    return cell(cfg, kind, seq, batch, mesh)


# ---------------------------------------------------------------------------
# schedule-optimizer fleet
# ---------------------------------------------------------------------------

def kernel_fleet_names(cfg: ModelConfig):
    """Registry names of the schedule-optimizable kernels this config's
    forward pass leans on (see :func:`kernel_fleet` for the scenario-
    annotated form the launchers consume)."""
    fleet = ["matmul_leakyrelu", "fused_ff"]
    if cfg.norm == "rmsnorm":
        fleet.append("rmsnorm")
    if cfg.family in ("ssm", "hybrid"):
        fleet.append("ssd")
    if cfg.family != "ssm":            # attention stacks
        fleet += ["flash_attention", "softmax", "bmm"]
    return fleet


def shape_scenario(cfg: ModelConfig, shape_name: str) -> Scenario:
    """The workload point a (config × shape) cell runs the kernels at.

    Train/prefill cells keep the core fully occupied; decode cells sit at
    half occupancy for large batches and low occupancy for the
    single-stream long-context shape (one token per step leaves most of
    the machine idle — a different best schedule than the saturated
    case)."""
    seq, batch, kind = SHAPES[shape_name]
    if kind in ("train", "prefill"):
        occ = "full"
    else:
        occ = "half" if batch >= 64 else "low"
    return Scenario(batch=batch, seq_len=seq, dtype=cfg.dtype, occupancy=occ)


def fleet_scenarios(cfg: ModelConfig):
    """Distinct workload points (one per scenario bucket) derived from the
    config's supported shapes, in shape order."""
    out, seen = [], set()
    for shape_name in cfg.supported_shapes:
        sc = shape_scenario(cfg, shape_name)
        if sc.bucket not in seen:
            seen.add(sc.bucket)
            out.append(sc)
    return out


def kernel_fleet(cfg: ModelConfig):
    """``(kernel, Scenario)`` pairs for every schedule-optimizable kernel
    this config's forward pass leans on, at every workload point its
    supported shapes imply — the fleet ``python -m repro_torch.launch.optimize
    --arch`` feeds to ``OptimizationSession.optimize_many`` and the
    serving launcher resolves through the schedule cache (one tuned
    schedule per kernel × scenario bucket)."""
    return [(name, sc) for name in kernel_fleet_names(cfg)
            for sc in fleet_scenarios(cfg)]
