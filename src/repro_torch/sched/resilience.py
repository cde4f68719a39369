"""Fault-tolerant measurement: retries, robust statistics, circuit
breaking, and the campaign failure ledger.

The paper's measurement channel is real hardware (§3.6) and its search
loop leans on repeated measurement and probabilistic testing precisely
because that channel flakes, hangs, crashes and returns outliers (§4).
This module is the simulated-stack counterpart: a decorator backend that
makes any :class:`repro_torch.sched.backends.MeasureBackend` survive the fault
modes :mod:`repro_torch.core.faults` injects.

* :class:`RetryPolicy` — the knobs: bounded retries with exponential
  backoff + deterministic jitter, a per-measure wall-clock deadline,
  median-of-k sampling with MAD outlier rejection (k adapts upward while
  the spread stays wide), and the circuit-breaker threshold.
* :class:`ResilientBackend` — wraps an inner backend.  One-shot timings
  (``time`` / ``autotune_time_fn``) get the full retry + robust-statistics
  treatment; machines handed to the assembly game
  (:meth:`ResilientBackend.new_machine`) are wrapped in
  :class:`ResilientMachine` so the game's direct ``machine.run`` /
  ``machine.time`` measurements retry too.  A *deterministic* inner
  backend (stock noise-free machine) passes straight through — the
  memoized fast path stays bit-exact with zero overhead.
* **Circuit breaker** — ``breaker_threshold`` *consecutive* hard
  failures (:class:`~repro_torch.core.faults.HardFault` or retry exhaustion)
  trip the breaker: from then on every measurement for that target is
  served by the deterministic scoreboard model (the
  :class:`~repro_torch.sched.backends.FastTimingBackend` semantics) instead of
  the faulty channel, and ``summary()`` reports the degradation.  Any
  success before the threshold resets the count, so one
  always-crashing cell in an otherwise healthy campaign fails alone
  without dragging its target into degraded mode.
* :class:`FailureLedger` — the persistent per-campaign record
  (``campaign_state.json``) of failed cells: error, attempt count, last
  backoff.  ``launch.optimize`` uses it for resumable supervised
  campaigns — a re-run retries exactly the failed cells, with backoff,
  up to ``--max-retries`` attempts.

Registered as ``BACKENDS["resilient"]`` so ``make_backend("resilient")``
and the launchers' ``--backend resilient`` compose it over the default
fast-timing backend.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.faults import HardFault, MeasureError, MeasureTimeout
from repro_torch.core.isa import Instruction
from repro_torch.core.machine import Machine, RunResult
from repro_torch.sched.backends import (BACKENDS, FastTimingBackend, MeasureBackend,
                                        SharedMeasureMemo)

# MAD -> sigma for normally distributed samples; the usual robust-stats
# consistency constant
_MAD_SIGMA = 1.4826


class MeasureExhausted(MeasureError):
    """The retry budget ran out without one successful measurement —
    the channel is persistently failing, not merely flaky.  Counts as a
    hard failure toward the circuit breaker."""


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs of the resilient measurement loop.

    ``max_retries`` bounds *extra* attempts per measurement (total =
    1 + max_retries).  ``backoff_s`` is the first retry's sleep, doubling
    (``backoff_mult``) each retry with up to ``jitter`` fractional
    deterministic jitter on top — 0 keeps tests instant.  ``timeout_s``
    is a per-measure wall-clock deadline: a call that returns *after* it
    (a hang / latency spike) is discarded and retried as a
    :class:`~repro_torch.core.faults.MeasureTimeout`.  ``samples`` is the
    median-of-k width for one-shot timings; MAD-rejected outliers are
    re-drawn and ``samples`` escalates (doubles, up to ``max_samples``)
    while the relative spread exceeds ``spread_tolerance``.
    ``breaker_threshold`` consecutive hard failures trip the circuit
    breaker (see module docstring).
    """

    max_retries: int = 4
    backoff_s: float = 0.0
    backoff_mult: float = 2.0
    jitter: float = 0.25
    timeout_s: Optional[float] = None
    samples: int = 1
    max_samples: int = 8
    mad_threshold: float = 3.5
    spread_tolerance: float = 0.05
    breaker_threshold: int = 3


class BackendHealth:
    """Shared mutable health state of one resilient backend (all machines
    it hands out report here).  Thread-compatible under the GIL: counter
    bumps are single int ops and the breaker latches one way."""

    def __init__(self):
        self.circuit_open = False
        self.consecutive_hard = 0
        self.counters = {
            "measures": 0, "retries": 0, "transients": 0, "timeouts": 0,
            "hard_faults": 0, "exhausted": 0, "outliers_rejected": 0,
            "sample_escalations": 0, "breaker_trips": 0, "degraded": 0,
        }

    def record_success(self) -> None:
        self.counters["measures"] += 1
        self.consecutive_hard = 0

    def record_hard(self, policy: RetryPolicy, kind: str) -> None:
        self.counters[kind] += 1
        self.consecutive_hard += 1
        if (not self.circuit_open
                and self.consecutive_hard >= policy.breaker_threshold):
            self.circuit_open = True
            self.counters["breaker_trips"] += 1


def call_with_retries(fn: Callable[[], "object"], policy: RetryPolicy,
                      health: BackendHealth,
                      rng: random.Random) -> "object":
    """Run one measurement through the retry loop: transient raises and
    post-hoc deadline violations are retried with exponential backoff +
    jitter; :class:`HardFault` propagates immediately (retrying a
    schedule that crashes the machine is futile); exhaustion raises
    :class:`MeasureExhausted`.  Both hard outcomes feed the breaker."""
    delay = policy.backoff_s
    last: Optional[MeasureError] = None
    for attempt in range(policy.max_retries + 1):
        if attempt:
            health.counters["retries"] += 1
            if delay > 0:
                time.sleep(delay * (1.0 + policy.jitter * rng.random()))
                delay *= policy.backoff_mult
        t0 = time.monotonic()
        try:
            value = fn()
        except HardFault:
            health.record_hard(policy, "hard_faults")
            raise
        except MeasureError as e:
            key = "timeouts" if isinstance(e, MeasureTimeout) else "transients"
            health.counters[key] += 1
            last = e
            continue
        if policy.timeout_s is not None \
                and time.monotonic() - t0 > policy.timeout_s:
            health.counters["timeouts"] += 1
            last = MeasureTimeout(
                f"measurement exceeded the {policy.timeout_s:.3f}s deadline")
            continue
        health.record_success()
        return value
    health.record_hard(policy, "exhausted")
    raise MeasureExhausted(
        f"measurement failed after {policy.max_retries + 1} attempts "
        f"(last: {last})") from last


class ResilientMachine(Machine):
    """The machine the assembly game / verifier sees when the inner
    channel can fault: every ``time``/``run``/``issue_times`` goes through
    the retry loop, and once the target's breaker is open, measurements
    are served by a private deterministic scoreboard machine instead
    (dataflow hashes from ``run`` stay real — the fallback is a full
    stock :class:`Machine`, not a timing surrogate)."""

    def __init__(self, inner: Machine, policy: RetryPolicy,
                 health: BackendHealth, rng: random.Random,
                 fallback: Optional[Machine] = None):
        super().__init__(noise=getattr(inner, "noise", 0.0), seed=0)
        self.inner = inner
        self.policy = policy
        self.health = health
        self._retry_rng = rng
        self.fallback = fallback if fallback is not None else Machine()

    def _measure(self, fn: Callable[[], "object"],
                 degraded_fn: Callable[[], "object"]) -> "object":
        if self.health.circuit_open:
            self.health.counters["degraded"] += 1
            return degraded_fn()
        try:
            return call_with_retries(fn, self.policy, self.health,
                                     self._retry_rng)
        except (HardFault, MeasureExhausted):
            if self.health.circuit_open:      # this failure tripped it
                self.health.counters["degraded"] += 1
                return degraded_fn()
            raise

    def time(self, program: Sequence[Instruction],
             input_seed: int = 0) -> float:
        return self._measure(lambda: self.inner.time(program, input_seed),
                             lambda: self.fallback.time(program, input_seed))

    def run(self, program: Sequence[Instruction], input_seed: int = 0,
            _serialize: bool = False) -> RunResult:
        return self._measure(
            lambda: self.inner.run(program, input_seed=input_seed,
                                   _serialize=_serialize),
            lambda: self.fallback.run(program, input_seed=input_seed,
                                      _serialize=_serialize))

    def issue_times(self, program: Sequence[Instruction]) -> List[float]:
        return self._measure(lambda: self.inner.issue_times(program),
                             lambda: self.fallback.issue_times(program))


class ResilientBackend:
    """Decorator :class:`MeasureBackend`: fault tolerance over any inner
    backend (see module docstring).  Composes through ``for_target`` —
    each target sibling wraps the inner backend's sibling with its *own*
    health/breaker (one wedged target must not degrade another), while
    ``summary()``/``stats()`` aggregate over the whole family."""

    fast_measure = True
    measure_workers: Optional[int] = None

    def __init__(self, inner: Optional[MeasureBackend] = None,
                 policy: Optional[RetryPolicy] = None,
                 fallback_factory: Callable[[], Machine] = Machine,
                 _family: Optional[List[BackendHealth]] = None):
        self.inner = inner if inner is not None else FastTimingBackend()
        self.policy = policy if policy is not None else RetryPolicy()
        self.name = f"resilient[{self.inner.name}]"
        self.fast_measure = self.inner.fast_measure
        self.measure_workers = self.inner.measure_workers
        self._fallback_factory = fallback_factory
        self.health = BackendHealth()
        self._family = _family if _family is not None else []
        self._family.append(self.health)
        self._rng = random.Random(0)
        self._machine: Optional[Machine] = None   # persistent faulty channel
        # the degraded path: deterministic scoreboard timing (shares the
        # inner memo when it has one, so degraded cells still memoize)
        memo = getattr(self.inner, "memo", None)
        self._fallback = FastTimingBackend(
            fallback_factory,
            memo=memo if isinstance(memo, SharedMeasureMemo) else None)

    # -- passthrough state ---------------------------------------------------

    @property
    def memo(self):
        return getattr(self.inner, "memo", None)

    @property
    def circuit_open(self) -> bool:
        return self.health.circuit_open

    @property
    def _deterministic(self) -> bool:
        """When the inner channel is already a pure function of the
        schedule, there is nothing to be resilient *against* — pass
        machines and memo views straight through so the fast path stays
        bit-exact and overhead-free."""
        return bool(getattr(self.inner, "deterministic", False))

    # -- MeasureBackend surface ----------------------------------------------

    def new_machine(self) -> Machine:
        if self._deterministic:
            return self.inner.new_machine()
        return ResilientMachine(self.inner.new_machine(), self.policy,
                                self.health, self._rng,
                                fallback=self._fallback_factory())

    def memo_view(self, program, owner: str = ""):
        if self.health.circuit_open:
            return self._fallback.memo_view(program, owner)
        return self.inner.memo_view(program, owner)

    def _measure_once(self, program, owner: str) -> float:
        if self._deterministic:
            fn = lambda: self.inner.time(program, owner)
        else:
            # ONE persistent machine for every one-shot timing: a fresh
            # machine per attempt would replay the same fault/noise stream
            # from its seed, making retries deterministic re-failures
            if self._machine is None:
                self._machine = self.inner.new_machine()
            fn = lambda: self._machine.time(program)
        return call_with_retries(fn, self.policy, self.health, self._rng)

    def _robust_time(self, program, owner: str = "") -> float:
        """Median-of-k with MAD rejection and adaptive k (policy knobs):
        draw ``samples`` retried measurements, reject the ones further
        than ``mad_threshold`` robust sigmas from the median, and double
        the sample count (up to ``max_samples``) while rejections happen
        or the kept spread stays above ``spread_tolerance``."""
        policy = self.policy
        k = max(1, policy.samples)
        vals: List[float] = []
        while True:
            while len(vals) < k:
                vals.append(self._measure_once(program, owner))
            if len(vals) == 1:
                return vals[0]
            med = statistics.median(vals)
            mad = statistics.median(abs(v - med) for v in vals)
            sigma = _MAD_SIGMA * mad
            kept = [v for v in vals
                    if sigma == 0 or abs(v - med) <= policy.mad_threshold * sigma]
            rejected = len(vals) - len(kept)
            self.health.counters["outliers_rejected"] += rejected
            spread = (statistics.median(abs(v - med) for v in kept) / med
                      if kept and med else 0.0)
            if (rejected or spread > policy.spread_tolerance) \
                    and k < policy.max_samples:
                self.health.counters["sample_escalations"] += 1
                k = min(policy.max_samples, k * 2)
                vals = kept
                continue
            return statistics.median(kept or vals)

    def time(self, program, owner: str = "") -> float:
        if self.health.circuit_open:
            self.health.counters["degraded"] += 1
            return self._fallback.time(program, owner)
        try:
            return self._robust_time(program, owner)
        except (HardFault, MeasureExhausted):
            if self.health.circuit_open:      # this failure tripped it
                self.health.counters["degraded"] += 1
                return self._fallback.time(program, owner)
            raise

    def autotune_time_fn(self, owner: str = "") -> Callable:
        if self._deterministic:
            return self.inner.autotune_time_fn(owner)
        return lambda program: self.time(program, owner)

    def for_target(self, machine_factory: Callable[[], Machine]
                   ) -> "ResilientBackend":
        return ResilientBackend(self.inner.for_target(machine_factory),
                                policy=self.policy,
                                fallback_factory=self._fallback_factory,
                                _family=self._family)

    # -- health reporting ----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Aggregated health counters over this backend and every target
        sibling it spawned via ``for_target``."""
        agg = {k: 0 for k in self.health.counters}
        open_breakers = 0
        for h in self._family:
            for k, v in h.counters.items():
                agg[k] += v
            open_breakers += int(h.circuit_open)
        agg["open_breakers"] = open_breakers
        agg["targets"] = len(self._family)
        return agg

    def summary(self) -> str:
        s = self.stats()
        line = (f"{s['measures']} measures, {s['retries']} retries "
                f"({s['transients']} transient, {s['timeouts']} timeout), "
                f"{s['hard_faults']} hard faults, "
                f"{s['outliers_rejected']} outliers rejected")
        if s["open_breakers"]:
            line += (f"; {s['open_breakers']}/{s['targets']} breakers OPEN "
                     f"({s['degraded']} degraded measures)")
        return line


# ---------------------------------------------------------------------------
# the campaign failure ledger
# ---------------------------------------------------------------------------

LEDGER_FORMAT = "repro-campaign-state"
LEDGER_VERSION = 1


def cell_key(kernel: str, scenario=None, target=None) -> str:
    """Stable id of one campaign cell: ``kernel@bucket@target``."""
    from repro_torch.sched.cache import _target_name
    from repro_torch.sched.scenario import bucket_of
    return f"{kernel}@{bucket_of(scenario)}@{_target_name(target)}"


class FailureLedger:
    """Persistent record of a campaign's failed cells
    (``campaign_state.json`` in the campaign's cache dir).

    Each entry carries the captured error, the attempt count across
    passes, and the last backoff applied — which is what makes campaigns
    *resumable*: a later pass consults :meth:`should_attempt` to retry
    exactly the failed cells (healthy ones resolve from the schedule
    cache), and :meth:`record_success` clears a cell once it finally
    lands.  Writes are atomic (tmp + rename) after every update, so a
    killed campaign never loses its ledger.  A corrupt ledger file is
    quarantined (``*.quarantine``) with a warning rather than killing
    the campaign it exists to protect — strict callers pass
    ``strict=True`` to keep the raise."""

    def __init__(self, path: str, strict: bool = False):
        self.path = path
        self._lock = threading.Lock()
        self.cells: Dict[str, Dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    payload = json.load(f)
                if payload.get("format") != LEDGER_FORMAT or \
                        payload.get("version") != LEDGER_VERSION:
                    raise ValueError(
                        f"not a {LEDGER_FORMAT} v{LEDGER_VERSION} file")
                self.cells = dict(payload.get("cells", {}))
            except (ValueError, OSError) as e:
                if strict:
                    raise RuntimeError(
                        f"corrupt campaign ledger {path}: {e}") from e
                quarantine = f"{path}.quarantine"
                os.replace(path, quarantine)
                warnings.warn(
                    f"corrupt campaign ledger {path} ({e}); quarantined to "
                    f"{quarantine}, starting an empty ledger")

    def save(self) -> None:
        payload = {"format": LEDGER_FORMAT, "version": LEDGER_VERSION,
                   "cells": self.cells}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    def attempts(self, cell: str) -> int:
        return int(self.cells.get(cell, {}).get("attempts", 0))

    def should_attempt(self, cell: str,
                       max_retries: Optional[int] = None) -> bool:
        """True while the cell's failure count is within the retry budget
        (``attempts <= max_retries`` — i.e. 1 + max_retries total tries;
        ``None`` = unbounded)."""
        if max_retries is None:
            return True
        return self.attempts(cell) <= max_retries

    def record_failure(self, cell: str, error: BaseException,
                       backoff: float = 0.0) -> Dict:
        with self._lock:
            entry = self.cells.setdefault(cell, {"attempts": 0})
            entry["attempts"] += 1
            entry["error"] = f"{type(error).__name__}: {error}"
            entry["error_type"] = type(error).__name__
            entry["last_backoff"] = backoff
            entry["wall_time"] = time.time()
            self.save()
            return dict(entry)

    def record_success(self, cell: str) -> None:
        with self._lock:
            if cell in self.cells:
                del self.cells[cell]
                self.save()

    def failed_cells(self) -> Dict[str, Dict]:
        return {k: dict(v) for k, v in sorted(self.cells.items())}

    def __len__(self) -> int:
        return len(self.cells)


BACKENDS["resilient"] = ResilientBackend
