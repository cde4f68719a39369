"""Compiler-integration layer: kernel tile function -> TSASS -> assembly
game -> cached optimized schedule (the paper's Triton integration, §4).

Port of ``repro/sched``.  The public surface is the session API
(:mod:`repro_torch.sched.session`): ``OptimizationSession`` over pluggable
measurement backends (:mod:`repro_torch.sched.backends`) and search
strategies, with fleet-scale ``optimize_many`` and index-driven
``deploy``.  The reference's deprecated ``CuAsmRL`` shim
(``sched/api.py``) is not ported (ROADMAP A7).
"""

# the session first: it binds the autotune *module*, which the line
# after it shadows with the function of the same name
from repro_torch.sched.session import (STRATEGIES, GreedySwapStrategy,
                                       KernelDef, OptimizationSession,
                                       OptimizeFailure, OptimizeRequest,
                                       OptimizeResult, PPOStrategy,
                                       RandomSearchStrategy, SearchOutcome,
                                       SearchStrategy, make_budgeted_strategy,
                                       make_strategy)
from repro_torch.sched.autotune import TuneResult, autotune
from repro_torch.sched.backends import (BACKENDS, FastTimingBackend,
                                        MeasureBackend, OracleBackend,
                                        PooledBackend, SharedMeasureMemo,
                                        make_backend)
from repro_torch.sched.baseline import naive_schedule, schedule
from repro_torch.sched.cache import (TARGET, Artifact, CacheVersionError,
                                     ScheduleCache, load, save)
from repro_torch.sched.lowering import (LoweredKernel, lower,
                                        resolve_schedule, schedule_plan)
from repro_torch.sched.resilience import (FailureLedger, ResilientBackend,
                                          RetryPolicy)
from repro_torch.sched.scenario import (DEFAULT_BUCKET, DEFAULT_TARGET,
                                        TARGETS, MachineTarget, Scenario,
                                        get_target, nearest_bucket,
                                        register_target, require_target,
                                        unregister_target)
from repro_torch.sched.spec import KernelSpec, TileIO
from repro_torch.sched.verify import probabilistic_test

__all__ = [
    # session API
    "OptimizationSession", "OptimizeRequest", "OptimizeResult",
    "OptimizeFailure", "SearchStrategy", "SearchOutcome", "PPOStrategy",
    "GreedySwapStrategy", "RandomSearchStrategy", "STRATEGIES",
    "make_strategy", "make_budgeted_strategy",
    # backends + resilience
    "MeasureBackend", "OracleBackend", "FastTimingBackend", "PooledBackend",
    "SharedMeasureMemo", "BACKENDS", "make_backend",
    "ResilientBackend", "RetryPolicy", "FailureLedger",
    # cache
    "Artifact", "ScheduleCache", "CacheVersionError", "load", "save",
    # scenario / target axes
    "Scenario", "MachineTarget", "TARGETS", "DEFAULT_BUCKET",
    "DEFAULT_TARGET", "get_target", "require_target", "register_target",
    "unregister_target", "nearest_bucket", "resolve_schedule",
    "schedule_plan",
    # building blocks
    "KernelDef", "TARGET", "TuneResult", "autotune", "naive_schedule",
    "schedule", "LoweredKernel", "lower", "KernelSpec", "TileIO",
    "probabilistic_test",
]
