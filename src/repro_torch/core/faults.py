"""Deterministic fault injection over the TSASS machine.

The paper's reward channel is *real hardware*: mutated SASS schedules are
executed on an A100 and timed (§3.6), a channel that in practice raises
(runtime hiccups), hangs (wedged kernels), crashes outright on illegal
schedules, and returns heavy-tailed timings — which is exactly why §4
leans on repeated measurement and probabilistic testing.  Our simulated
machine has none of these failure modes, so the retry / robust-statistics
/ circuit-breaker machinery in :mod:`repro_torch.sched.resilience` would be
untestable.  :class:`FaultyMachine` closes that gap: a seeded,
deterministic wrapper over any :class:`~repro_torch.core.machine.Machine` that
injects configurable faults into every measurement call:

* **transient raises** — :class:`MeasureError` with probability
  ``transient_rate`` (the flaky-channel mode retries must absorb);
* **hangs** — with probability ``hang_rate`` the call sleeps ``hang_s``
  wall seconds before returning, so a per-measure deadline
  (:class:`repro_torch.sched.resilience.RetryPolicy.timeout_s`) can observe a
  latency spike past its budget;
* **hard crashes** — schedules whose :func:`schedule_fingerprint` is in
  ``crash_fingerprints`` always raise :class:`HardFault` (the
  kernel-kills-the-GPU mode retries must *not* absorb);
* **timing outliers** — with probability ``outlier_rate`` the returned
  cycle count is inflated by a Pareto-tailed factor (the
  noisy-neighbour mode median-of-k + MAD rejection must absorb).

Faults draw from one seeded ``random.Random`` stream advanced per
measurement, so a given (seed, call sequence) replays bit-identically —
every resilience path is testable without real hardware.  The wrapper
overrides ``run``, so the assembly game's fast-measure precondition
(``type(machine).run is Machine.run``) correctly falls back to the oracle
path and the fault channel is actually exercised.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time
from typing import FrozenSet, Iterable, List, Optional, Sequence

from repro_torch.core.isa import Instruction
from repro_torch.core.machine import Machine, RunResult


class MeasureError(RuntimeError):
    """A transient measurement failure — the channel flaked, the value is
    lost, retrying the same schedule may well succeed."""


class MeasureTimeout(MeasureError):
    """A measurement exceeded its wall-clock deadline (simulated hang).
    A subclass of :class:`MeasureError` because the retry policy treats
    both the same way: discard, back off, retry."""


class HardFault(RuntimeError):
    """A non-transient measurement failure — the schedule itself crashes
    the machine.  Retrying the identical schedule is futile; the
    resilience layer counts these toward its circuit breaker instead."""


def schedule_fingerprint(program: Sequence[Instruction]) -> str:
    """Stable, permutation-invariant fingerprint of a program.

    Hashes the *sorted multiset* of ``opcode operands`` lines (``.reuse``
    hints stripped — they are scheduler-assigned adjacency metadata, not
    identity), so every reordering the assembly game can reach from one
    lowered kernel shares a fingerprint.  That makes a fingerprint the
    identity of a *(kernel, config, scenario)* measurement cell: pinning
    one in :attr:`FaultSpec.crash_fingerprints` crashes that cell's every
    measurement — baseline, autotune grid point, search mutation and
    verification alike — without touching any sibling cell.
    """
    h = hashlib.sha256()
    for line in sorted(
            f"{ins.opcode} {','.join(ins.operands)}".replace(".reuse", "")
            for ins in program):
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Configuration of one fault channel (see module docstring).

    Rates are independent per-measurement probabilities; a rate of 0
    draws nothing from the RNG stream, so enabling one mode never shifts
    another mode's deterministic sequence.
    """

    seed: int = 0
    transient_rate: float = 0.0
    hang_rate: float = 0.0
    hang_s: float = 0.0
    crash_fingerprints: FrozenSet[str] = frozenset()
    outlier_rate: float = 0.0
    outlier_scale: float = 10.0      # tail weight of the injected spike

    def __post_init__(self):
        object.__setattr__(self, "crash_fingerprints",
                           frozenset(self.crash_fingerprints))
        for name in ("transient_rate", "hang_rate", "outlier_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    def with_crashes(self, fingerprints: Iterable[str]) -> "FaultSpec":
        return dataclasses.replace(
            self, crash_fingerprints=frozenset(fingerprints)
            | self.crash_fingerprints)


class FaultyMachine(Machine):
    """A :class:`Machine` whose measurement calls fault per ``spec``.

    Wraps ``machine`` (a stock noise-free :class:`Machine` by default);
    when no fault fires, results are byte-identical to the wrapped
    machine's — which is what lets a resilient campaign over a faulty
    fleet reproduce a fault-free campaign bit-exactly once every
    transient has been retried away.  ``fault_counters`` tallies injected
    faults by mode for tests and benchmark reporting.
    """

    def __init__(self, spec: Optional[FaultSpec] = None,
                 machine: Optional[Machine] = None):
        inner = machine if machine is not None else Machine()
        super().__init__(noise=getattr(inner, "noise", 0.0), seed=0)
        self.inner = inner
        self.spec = spec if spec is not None else FaultSpec()
        self._frng = random.Random(self.spec.seed)
        self.fault_counters = {"measures": 0, "transients": 0, "hangs": 0,
                               "crashes": 0, "outliers": 0}

    def _inject(self, program: Sequence[Instruction]) -> None:
        spec = self.spec
        self.fault_counters["measures"] += 1
        if spec.crash_fingerprints \
                and schedule_fingerprint(program) in spec.crash_fingerprints:
            self.fault_counters["crashes"] += 1
            raise HardFault(
                f"schedule {schedule_fingerprint(program)} crashes the "
                f"machine (injected hard fault)")
        if spec.hang_rate and self._frng.random() < spec.hang_rate:
            self.fault_counters["hangs"] += 1
            time.sleep(spec.hang_s)
        if spec.transient_rate and self._frng.random() < spec.transient_rate:
            self.fault_counters["transients"] += 1
            raise MeasureError("transient measurement failure (injected)")

    def _maybe_outlier(self, cycles: float) -> float:
        spec = self.spec
        if spec.outlier_rate and self._frng.random() < spec.outlier_rate:
            self.fault_counters["outliers"] += 1
            # Pareto(alpha=1.5) - 1 >= 0 with a heavy right tail: rare
            # measurements come back inflated by orders of magnitude
            cycles *= 1.0 + spec.outlier_scale * \
                (self._frng.paretovariate(1.5) - 1.0)
        return cycles

    # -- the Machine measurement surface -------------------------------------

    def time(self, program: Sequence[Instruction],
             input_seed: int = 0) -> float:
        self._inject(program)
        return self._maybe_outlier(self.inner.time(program, input_seed))

    def run(self, program: Sequence[Instruction], input_seed: int = 0,
            _serialize: bool = False) -> RunResult:
        self._inject(program)
        res = self.inner.run(program, input_seed=input_seed,
                             _serialize=_serialize)
        cycles = self._maybe_outlier(res.cycles)
        if cycles != res.cycles:
            res = dataclasses.replace(res, cycles=cycles)
        return res

    def issue_times(self, program: Sequence[Instruction]) -> List[float]:
        self._inject(program)
        return self.inner.issue_times(program)
