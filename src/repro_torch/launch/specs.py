"""Workload points of the schedule optimizer's kernel fleet.

Port of the four jax-free functions of ``repro/launch/specs.py``
(``kernel_fleet_names``, ``shape_scenario``, ``fleet_scenarios``,
``kernel_fleet``), over the port's ``configs/base.py::SHAPES``.  The
reference module's lowerable half (abstract params, shardings, AOT
steps) is ROADMAP A14.
"""

from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.sched.scenario import Scenario


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
