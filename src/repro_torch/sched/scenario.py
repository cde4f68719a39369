"""Scenario and machine-target axes of the schedule optimizer.

The paper optimizes one kernel for one shape on one GPU.  Production
serving does not look like that: the same kernel runs under many traffic
mixes (batch size, sequence length, dtype, occupancy) on several machine
generations, and a schedule tuned for one point serves every other point
stale.  This module makes both axes first-class, typed values that the
whole optimize -> cache -> serve stack plumbs through instead of assuming
a single implicit global:

* :class:`Scenario` — one workload point.  Scenarios quantize into
  **buckets** (power-of-two edges on batch and sequence length, exact
  dtype / occupancy class), which are the cache-index keys: tuning happens
  per bucket, and serve-time dispatch resolves a request's shape to the
  *nearest* tuned bucket (:func:`nearest_bucket`) as a pure index lookup.
* :class:`MachineTarget` — the machine-model identity that replaces the
  bare ``cache.TARGET`` string: the cache-partition name plus the machine
  configuration (noise / seed — and, for downstream machine models, a
  factory override) that stall tables and measurements are built from.
  Targets register in :data:`TARGETS`; campaign CLIs resolve names through
  :func:`require_target` so typos fail loudly, while :func:`get_target`
  still admits ad-hoc names for tests and private cache partitions.

``scenario=None`` everywhere means the legacy single-point behaviour: the
``"default"`` bucket, byte-identical cache keys, identical specs.  That is
what lets pre-scenario (v1/v2) cache directories load through unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.core.machine import Machine

# the bucket every pre-scenario artifact lives in, and the bucket a
# scenario-less optimize/deploy resolves to
DEFAULT_BUCKET = "default"

_OCCUPANCIES = ("low", "half", "full")
_DTYPE_ALIASES = {"bfloat16": "bf16", "float32": "f32", "float16": "f16",
                  "fp32": "f32", "fp16": "f16", "int8": "i8", "int32": "i32"}


def _pow2_bucket(n: int) -> int:
    """Round up to the bucket's power-of-two edge (1, 2, 4, ...)."""
    n = max(int(n), 1)
    return 1 << max(n - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One workload point a kernel is tuned for.

    ``batch``/``seq_len`` describe the traffic shape, ``dtype`` the tile
    element type the kernel moves, ``occupancy`` the load class of the
    serving replica ("low" = trickle/long-context decode, "half" = steady
    decode, "full" = saturated train/prefill).  Two scenarios inside the
    same bucket share one tuned schedule.
    """

    batch: int = 1
    seq_len: int = 4096
    dtype: str = "bf16"
    occupancy: str = "full"

    def __post_init__(self):
        object.__setattr__(self, "dtype",
                           _DTYPE_ALIASES.get(self.dtype, self.dtype))
        if self.occupancy not in _OCCUPANCIES:
            raise ValueError(f"unknown occupancy {self.occupancy!r}; "
                             f"one of {_OCCUPANCIES}")
        if self.batch < 1 or self.seq_len < 1:
            raise ValueError(f"batch/seq_len must be >= 1, got "
                             f"{self.batch}/{self.seq_len}")

    @property
    def rows(self) -> int:
        """Total rows of work the scenario streams through a row-tiled
        kernel (what sets the trip count in spec construction)."""
        return self.batch * self.seq_len

    @property
    def bucket(self) -> str:
        """Canonical bucket key: power-of-two batch/seq edges, exact
        dtype and occupancy — the cache-index scenario key."""
        return (f"b{_pow2_bucket(self.batch)}_s{_pow2_bucket(self.seq_len)}"
                f"_{self.dtype}_{self.occupancy}")

    @classmethod
    def parse(cls, text: str) -> "Scenario":
        """Parse the CLI form ``BATCHxSEQ[xDTYPE[xOCCUPANCY]]``
        (e.g. ``256x4096``, ``8x32768xbf16xhalf``)."""
        parts = text.lower().split("x")
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(
                f"bad scenario {text!r}: expected BATCHxSEQ[xDTYPE[xOCC]], "
                f"e.g. 256x4096xbf16xfull")
        try:
            batch, seq = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(f"bad scenario {text!r}: batch/seq must be "
                             f"integers") from None
        kw = {}
        if len(parts) >= 3:
            kw["dtype"] = parts[2]
        if len(parts) == 4:
            kw["occupancy"] = parts[3]
        return cls(batch=batch, seq_len=seq, **kw)

    def describe(self) -> str:
        return (f"batch={self.batch} seq={self.seq_len} dtype={self.dtype} "
                f"occupancy={self.occupancy} -> {self.bucket}")


def bucket_of(scenario: Union[Scenario, str, None]) -> str:
    """Normalize a scenario / bucket string / None to a bucket key."""
    if scenario is None:
        return DEFAULT_BUCKET
    if isinstance(scenario, Scenario):
        return scenario.bucket
    return str(scenario)


def parse_bucket(bucket: str) -> Optional[Tuple[int, int, str, str]]:
    """``b8_s4096_bf16_full`` -> (8, 4096, "bf16", "full"); ``None`` for
    the default bucket or anything unparseable (treated as infinitely far
    by :func:`nearest_bucket`, reachable only as a fallback)."""
    parts = bucket.split("_")
    if len(parts) != 4 or not parts[0].startswith("b") \
            or not parts[1].startswith("s"):
        return None
    try:
        return (int(parts[0][1:]), int(parts[1][1:]), parts[2], parts[3])
    except ValueError:
        return None


def bucket_distance(scenario: Scenario, bucket: str) -> float:
    """Dispatch metric: log2 distance on batch and seq, a large penalty
    for a dtype mismatch (wrong tile bytes), a small one for occupancy."""
    parsed = parse_bucket(bucket)
    if parsed is None:
        return math.inf
    b, s, dtype, occ = parsed
    d = abs(math.log2(_pow2_bucket(scenario.batch)) - math.log2(b)) \
        + abs(math.log2(_pow2_bucket(scenario.seq_len)) - math.log2(s))
    if dtype != scenario.dtype:
        d += 16.0
    if occ != scenario.occupancy:
        d += 1.0
    return d


def nearest_bucket(buckets: Iterable[str],
                   scenario: Union[Scenario, str, None]) -> Optional[str]:
    """The tuned bucket a request shape dispatches to.

    Exact bucket match wins; otherwise the nearest by
    :func:`bucket_distance` (ties break lexicographically, so dispatch is
    deterministic across processes); the default bucket is the fallback of
    last resort.  ``None`` when nothing is tuned at all.
    """
    buckets = sorted(set(buckets))
    if not buckets:
        return None
    want = bucket_of(scenario)
    if want in buckets:
        return want
    if not isinstance(scenario, Scenario):
        # a raw bucket string with no exact match: re-parse it so distance
        # dispatch still works for index-to-index migration tools
        parsed = parse_bucket(want)
        if parsed is None:
            return DEFAULT_BUCKET if DEFAULT_BUCKET in buckets else buckets[0]
        scenario = Scenario(batch=parsed[0], seq_len=parsed[1],
                            dtype=parsed[2], occupancy=parsed[3])
    scored = [(bucket_distance(scenario, b), b) for b in buckets]
    finite = [x for x in scored if math.isfinite(x[0])]
    if finite:
        return min(finite)[1]
    return DEFAULT_BUCKET if DEFAULT_BUCKET in buckets else buckets[0]


def scenario_steps(scenario: Optional[Scenario], rows_per_step: int,
                   default: int) -> int:
    """Steady-state trip count to materialize for a scenario: how many
    row tiles the workload streams per core, clamped to the 2..8 window
    the lowering unrolls.  ``scenario=None`` keeps the kernel's legacy
    single-point default (bit-identical specs, the v2 compat guarantee);
    low occupancy halves the materialized window (fewer resident tiles)."""
    if scenario is None:
        return default
    steps = scenario.rows // max(rows_per_step * 1024, 1)
    if scenario.occupancy == "low":
        steps //= 2
    return max(2, min(8, steps if steps else 2))


# ---------------------------------------------------------------------------
# MachineTarget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineTarget:
    """Identity + machine model of one optimization target.

    Replaces the bare ``cache.TARGET`` string: ``name`` is still the cache
    partition key (on-disk layout is unchanged for the default target), but
    the target now also *carries* the machine configuration its stall table
    and measurements are built from — so a session can hold per-target
    stall tables keyed by the target itself, and a campaign over several
    targets never mixes their measurements.

    ``machine_factory`` admits downstream machine models (a subclassed
    :class:`Machine` with different latency tables); it is excluded from
    equality/hash so two handles to the same named target compare equal.
    """

    name: str = "tpu-tsass-v1"
    noise: float = 0.0
    seed: int = 0
    machine_factory: Optional[Callable[[], Machine]] = \
        dataclasses.field(default=None, compare=False)

    def new_machine(self) -> Machine:
        if self.machine_factory is not None:
            return self.machine_factory()
        return Machine(noise=self.noise, seed=self.seed)

    def __str__(self) -> str:       # cache paths / log lines
        return self.name


# the registered fleet of machine targets campaigns can address by name.
# Both built-ins run the same TSASS simulator (the repo has exactly one
# machine model); v2 is the sibling pod generation's cache partition —
# real table differences arrive via MachineTarget.machine_factory.
TARGETS: Dict[str, MachineTarget] = {}


def register_target(target: MachineTarget) -> MachineTarget:
    """Register ``target`` under its name (last registration wins, so
    tests can shadow and restore entries).  Returns the target."""
    if not isinstance(target, MachineTarget):
        raise TypeError(f"register_target expects a MachineTarget, "
                        f"got {target!r}")
    TARGETS[target.name] = target
    return target


def unregister_target(name: str) -> None:
    TARGETS.pop(name, None)


DEFAULT_TARGET = register_target(MachineTarget("tpu-tsass-v1"))
register_target(MachineTarget("tpu-tsass-v2", seed=1))


def get_target(target: Union[str, MachineTarget, None]) -> MachineTarget:
    """Normalize to a :class:`MachineTarget`.  Registered names resolve to
    their registered entry; unknown names become ad-hoc stock-machine
    targets (private cache partitions, tests) — campaign CLIs that must
    reject typos use :func:`require_target` instead."""
    if target is None:
        return DEFAULT_TARGET
    if isinstance(target, MachineTarget):
        return target
    known = TARGETS.get(str(target))
    return known if known is not None else MachineTarget(str(target))


def require_target(name: Union[str, MachineTarget]) -> MachineTarget:
    """Like :func:`get_target` but unknown names fail loudly, listing the
    registered targets — the ``--targets`` CLI contract."""
    if isinstance(name, MachineTarget):
        return name
    try:
        return TARGETS[str(name)]
    except KeyError:
        raise KeyError(
            f"unknown machine target {name!r}; registered targets: "
            f"{sorted(TARGETS)} (register_target() adds more)") from None


def build_spec(make_spec: Callable, config: Dict,
               scenario: Optional[Scenario] = None):
    """Construct a kernel spec, passing ``scenario`` through to
    scenario-aware ``make_spec`` constructors (those declaring a ``scenario``
    parameter) and silently omitting it for legacy single-point constructors —
    the one place the optional-axis dispatch lives."""
    if scenario is not None and _accepts_scenario(make_spec):
        return make_spec(config, scenario=scenario)
    return make_spec(config)


def _accepts_scenario(fn: Callable) -> bool:
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    if "scenario" in sig.parameters:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())


__all__: List[str] = [
    "DEFAULT_BUCKET", "DEFAULT_TARGET", "MachineTarget", "Scenario",
    "TARGETS", "bucket_distance", "bucket_of", "build_spec", "get_target",
    "nearest_bucket", "parse_bucket", "register_target", "require_target",
    "scenario_steps", "unregister_target",
]
