"""Hierarchical search, stage 1 (paper §3.1): autotune kernel configurations
before the RL agent optimizes the schedule of the best one.

"The autotuner employs a grid search-like strategy, which enumerates
user-provided kernel configurations, compiles with the kernel
configurations, measures the execution throughput on the target GPU, and
greedily selects as well as caches the optimal set of kernel
configurations."  Our target is the TSASS machine; the figure of merit is
useful work per cycle (configs move different tile volumes per step, so raw
cycles are not comparable).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.machine import Machine
from repro_torch.sched import baseline, lowering
from repro_torch.sched.scenario import Scenario, build_spec
from repro_torch.sched.spec import KernelSpec


@dataclasses.dataclass
class TuneEntry:
    config: Dict
    cycles: float
    work_per_cycle: float
    num_instructions: int


@dataclasses.dataclass
class TuneResult:
    best: TuneEntry
    entries: List[TuneEntry]


def _work_per_step(spec: KernelSpec) -> float:
    if spec.flops_per_step:
        return float(spec.flops_per_step)
    return float(sum(t.nbytes for t in spec.inputs + spec.outputs))


def autotune(make_spec: Callable[[Dict], KernelSpec], configs: List[Dict],
             machine: Optional[Machine] = None,
             time_fn: Optional[Callable] = None,
             scenario: Optional[Scenario] = None) -> TuneResult:
    """``time_fn`` (program -> cycles) overrides the measurement path — the
    session injects its backend here so grid timings land in the shared
    memo; default is the machine's timing-only executor.  ``scenario``
    flows into spec construction (scenario-aware constructors materialize the
    scenario's tile stream), so the grid is scored per workload point —
    the same config grid can pick different winners per bucket."""
    if time_fn is None:
        machine = machine or Machine()
        time_fn = machine.time
    entries: List[TuneEntry] = []
    for cfg in configs:
        spec = build_spec(make_spec, cfg, scenario)
        program = baseline.schedule(lowering.lower(spec))
        # grid points only need cycle counts: timing-only path (bit-exact
        # against machine.run(program).cycles), no dataflow simulation
        cycles = time_fn(program)
        work = _work_per_step(spec) * spec.steps
        entries.append(TuneEntry(cfg, cycles, work / max(cycles, 1.0),
                                 len(program)))
    best = max(entries, key=lambda e: e.work_per_cycle)
    return TuneResult(best=best, entries=entries)
