"""Measurement backends for the optimization session (API redesign).

A :class:`MeasureBackend` answers one question — "how many cycles does this
schedule take?" — and carries the knobs the assembly game and the autotuner
need to answer it consistently: a machine factory, whether the timing-only
fast path applies, how many worker threads may prime measurement misses,
and (for the fast backends) the **cross-kernel measurement memo**.

The memo (:class:`SharedMeasureMemo`) is the fleet-scale piece: it maps
``(program fingerprint, position->identity permutation)`` to cycles, where
the fingerprint is interned from the per-instruction *timing records*
(:func:`repro_torch.core.timing.time_record`) — the complete timing semantics of
an instruction identity.  Two kernels whose lowered programs share the same
record sequence (the same kernel appearing under several registry names /
workloads in a fleet, re-optimization of an already-seen schedule) therefore
share every measurement, and ``cross_kernel_hits`` counts reads served by an
entry another kernel wrote.  Timing is bit-exact and deterministic
(``tests/test_timing_fast.py``), so sharing never changes measured values —
only how often they are recomputed.

Backends:

* :class:`OracleBackend` — every measurement through the full dataflow
  oracle ``Machine.run`` (the pre-fast-path behaviour; reference + noisy /
  subclassed machines).
* :class:`FastTimingBackend` — the timing-only path
  (:class:`repro_torch.core.timing.ScheduleTimer` inside the game, memoized
  one-shot timing elsewhere) behind the shared memo.
* :class:`PooledBackend` — FastTiming plus a thread pool over which the
  batched rollout primes distinct measurement misses concurrently.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import (Callable, Dict, Iterator, NamedTuple, Optional, Protocol,
                    Sequence, runtime_checkable)

import numpy as np

from repro_torch.core.isa import Instruction
from repro_torch.core.machine import Machine
from repro_torch.core.timing import time_program, time_record

# disk format for persisted memos (SharedMeasureMemo.save/load).  Bump the
# version on layout changes; unknown versions and corrupt files fail
# loudly (MemoVersionError) — a half-read memo warm-start would silently
# waste a re-optimization campaign, exactly the failure mode schedule
# cache v2 rules out.
MEMO_FORMAT = "repro-measure-memo"
MEMO_VERSION = 1
_KNOWN_MEMO_VERSIONS = (1,)


class MemoVersionError(RuntimeError):
    """A persisted measurement memo is corrupt or from an unknown format
    version.  Deliberately loud (like ``sched.cache.CacheVersionError``):
    callers wanting best-effort warm-starts catch exactly this."""


# ---------------------------------------------------------------------------
# cross-kernel measurement memo
# ---------------------------------------------------------------------------

class MemoEntry(NamedTuple):
    """One exported measurement: which program (by interned fingerprint and
    its timing-record sequence), which schedule (position -> identity
    permutation), and the measured cycles."""
    fingerprint: int
    records: tuple
    permutation: Optional[np.ndarray]   # None for non-permutation keys
    cycles: float
    writer: str

class _MemoView:
    """Dict-like view of a :class:`SharedMeasureMemo` for one program.

    Keys are the game's permutation bytes (``id_at.tobytes()``); the view
    namespaces them under the program's interned fingerprint, so distinct
    programs can never collide while identical ones (same timing records)
    share entries.  Implements exactly the mapping surface
    :class:`repro_torch.core.env.AssemblyGame` uses for its ``measure_cache``.
    """

    __slots__ = ("_memo", "_fp", "owner")

    def __init__(self, memo: "SharedMeasureMemo", fp: int, owner: str):
        self._memo = memo
        self._fp = fp
        self.owner = owner

    def get(self, key, default=None):
        entry = self._memo._data.get((self._fp, key))
        if entry is None:
            return default
        cycles, writer = entry
        self._memo.hits += 1
        if writer != self.owner:
            self._memo.cross_kernel_hits += 1
        return cycles

    def __contains__(self, key) -> bool:
        return (self._fp, key) in self._memo._data

    def __setitem__(self, key, cycles: float) -> None:
        self._memo._insert((self._fp, key), (cycles, self.owner))


class SharedMeasureMemo:
    """Schedule -> cycles memo shared across kernels, envs and phases.

    Thread-compatible under the GIL: entry reads/writes are single dict
    operations and identical values make write races benign; the counters
    are best-effort under concurrent fleets (exact in the default serial
    ``optimize_many``).

    ``max_entries`` bounds resident memory over long measurement campaigns
    (keys are full permutation byte-strings): when exceeded, the oldest
    eighth of the entries is dropped — eviction only costs re-timing, never
    correctness.
    """

    def __init__(self, max_entries: int = 250_000):
        self._data: Dict[tuple, tuple] = {}
        self._fp_ids: Dict[tuple, int] = {}   # record-tuple -> interned id
        self._lock = threading.Lock()
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        self.cross_kernel_hits = 0
        self.evictions = 0

    def _insert(self, key: tuple, entry: tuple) -> None:
        data = self._data
        if key in data:               # first writer wins; values bit-exact
            return
        data[key] = entry
        self.misses += 1
        if len(data) > self.max_entries:
            # dicts preserve insertion order: drop the oldest ~1/8 batch
            drop = [k for i, k in enumerate(data)
                    if i < max(1, self.max_entries // 8)]
            for k in drop:
                del data[k]
            self.evictions += len(drop)

    def fingerprint(self, program: Sequence[Instruction]) -> int:
        """Interned id of the program's timing-record sequence.  Structural:
        two instruction lists with equal records get the same id."""
        recs = tuple(time_record(ins) for ins in program)
        with self._lock:
            fp = self._fp_ids.get(recs)
            if fp is None:
                fp = len(self._fp_ids)
                self._fp_ids[recs] = fp
            return fp

    def view(self, program: Sequence[Instruction], owner: str = "") -> _MemoView:
        return _MemoView(self, self.fingerprint(program), owner)

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._data),
            "programs": len(self._fp_ids),
            "hits": self.hits,
            "misses": self.misses,
            "cross_kernel_hits": self.cross_kernel_hits,
            "evictions": self.evictions,
        }

    def summary(self) -> str:
        """One-line human-readable stats (shared by the CLI, examples and
        benchmarks so the format lives in exactly one place)."""
        s = self.stats()
        total = max(s["hits"] + s["misses"], 1)
        return (f"{s['entries']} entries, {s['hits']}/{total} hits "
                f"({s['hits'] / total:.1%}), {s['cross_kernel_hits']} "
                f"cross-kernel")

    def __len__(self) -> int:
        return len(self._data)

    def export_entries(self) -> Iterator[MemoEntry]:
        """Iterate every *resident* measurement as a :class:`MemoEntry` —
        the public export hook the cost-model dataset code consumes, so
        nothing outside this module reaches into ``_data`` / ``_fp_ids``.

        Permutation keys (the game's ``id_at.tobytes()`` and the one-shot
        ``np.arange`` keys) decode back to int64 arrays; any other key
        shape exports with ``permutation=None``.  Eviction caveat: the memo
        bounds resident memory by dropping its oldest entries, so evicted
        measurements are simply **absent** from exports — an export is a
        snapshot of what is currently resident, not a full measurement log.
        """
        with self._lock:
            recs_of = {fp: recs for recs, fp in self._fp_ids.items()}
        for (fp, key), (cycles, writer) in list(self._data.items()):
            recs = recs_of.get(fp)
            if recs is None:
                continue
            perm = None
            if isinstance(key, bytes) and len(key) % 8 == 0:
                perm = np.frombuffer(key, dtype=np.int64).copy()
            yield MemoEntry(fp, recs, perm, cycles, writer)

    # -- persistence (fleet warm-starts across campaigns) -------------------

    def save(self, path: str, merge: bool = True) -> int:
        """Persist every entry to ``path`` (atomic: tmp file + rename).

        The on-disk layout stores the *timing-record sequences* themselves
        — not the process-local interned fingerprint ids, which a fresh
        process would assign differently.

        ``merge=True`` (the default) first folds an existing file at
        ``path`` into the written payload, so concurrent campaign writers
        sharing one ``--memo-dir`` converge on the union of their
        measurements instead of last-writer-wins (values are bit-exact, so
        whose copy of a shared entry survives is immaterial).  The window
        between the read and the atomic rename can still drop entries a
        racing writer lands *inside* it — eviction-grade loss that only
        costs re-timing, never correctness.  Returns the number of entries
        written; raises :class:`MemoVersionError` when the existing file
        is corrupt (overwriting it silently could destroy a healthy
        sibling campaign's work — pass ``merge=False`` to clobber)."""
        by_recs: Dict[tuple, Dict] = {}
        recs_of = {fp: recs for recs, fp in self._fp_ids.items()}
        for (fp, key), (cycles, writer) in self._data.items():
            if fp in recs_of:
                by_recs.setdefault(recs_of[fp], {})[key] = (cycles, writer)
        if merge and os.path.exists(path):
            for prog in _read_memo_payload(path)["programs"]:
                dst = by_recs.setdefault(tuple(prog["records"]), {})
                for key, cycles, writer in prog["entries"]:
                    dst.setdefault(key, (cycles, writer))   # ours win
        payload = {
            "format": MEMO_FORMAT,
            "version": MEMO_VERSION,
            "programs": [
                {"records": recs,
                 "entries": [(k, c, w) for k, (c, w) in entries.items()]}
                for recs, entries in by_recs.items()
            ],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return sum(len(e) for e in by_recs.values())

    def load(self, path: str) -> int:
        """Merge the memo persisted at ``path`` into this one (existing
        entries win — values are bit-exact anyway, and first-writer-wins is
        the in-memory rule too).  Returns the number of entries merged.
        Raises :class:`MemoVersionError` on corrupt or unknown-version
        files."""
        payload = _read_memo_payload(path)
        merged = 0
        for prog in payload["programs"]:
            recs = tuple(prog["records"])
            with self._lock:
                fp = self._fp_ids.get(recs)
                if fp is None:
                    fp = len(self._fp_ids)
                    self._fp_ids[recs] = fp
            for key, cycles, writer in prog["entries"]:
                k = (fp, key)
                if k not in self._data:
                    self._data[k] = (cycles, writer)
                    merged += 1
        return merged


def warm_start_memo(memo: SharedMeasureMemo, path: str,
                    strict: bool = False) -> int:
    """Best-effort campaign warm-start: merge the memo persisted at
    ``path`` into ``memo``, treating corruption as a recoverable event.

    A corrupt or unknown-version file is renamed to ``path + ".quarantine"``
    with a warning and the campaign starts from an empty memo — losing a
    warm-start only costs re-timing, while dying on it costs the whole
    campaign (the failure mode this module's loud :meth:`SharedMeasureMemo.load`
    is *for* when callers want strictness; ``strict=True`` keeps that
    raise).  Missing files are simply an empty warm-start.  Returns the
    number of entries merged."""
    import warnings
    if not os.path.exists(path):
        return 0
    try:
        return memo.load(path)
    except MemoVersionError as e:
        if strict:
            raise
        quarantine = f"{path}.quarantine"
        os.replace(path, quarantine)
        warnings.warn(
            f"corrupt measurement memo {path} ({e}); quarantined to "
            f"{quarantine}, starting from an empty memo")
        return 0


def _read_memo_payload(path: str) -> dict:
    """Read + validate one persisted memo payload (shared by load and the
    merge-on-save path; every failure mode is a loud MemoVersionError)."""
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, IndexError) as e:
        raise MemoVersionError(
            f"corrupt measurement memo {path}: {e}") from e
    if not isinstance(payload, dict) \
            or payload.get("format") != MEMO_FORMAT:
        raise MemoVersionError(
            f"{path} is not a {MEMO_FORMAT} file")
    if payload.get("version") not in _KNOWN_MEMO_VERSIONS:
        raise MemoVersionError(
            f"measurement memo {path} has version "
            f"{payload.get('version')!r}; this build reads "
            f"{_KNOWN_MEMO_VERSIONS}")
    return payload


# ---------------------------------------------------------------------------
# backend protocol + implementations
# ---------------------------------------------------------------------------

@runtime_checkable
class MeasureBackend(Protocol):
    """What a search strategy / the session needs from a measurement path."""

    name: str
    fast_measure: bool                    # AssemblyGame(use_fast_measure=...)
    measure_workers: Optional[int]        # train_on_program worker pool size

    def new_machine(self) -> Machine:
        """A fresh machine (one per env, the legacy ``machine_factory``)."""
        ...

    def memo_view(self, program: Sequence[Instruction],
                  owner: str = "") -> Optional[_MemoView]:
        """Shared-memo view for ``program`` (``None`` = no sharing)."""
        ...

    def time(self, program: Sequence[Instruction], owner: str = "") -> float:
        """One-shot cycle count of ``program`` (autotune / baselines)."""
        ...

    def autotune_time_fn(self, owner: str = "") -> Callable:
        """A program->cycles callable for one autotune grid sweep."""
        ...

    def for_target(self, machine_factory: Callable[[], Machine]
                   ) -> "MeasureBackend":
        """A sibling backend measuring through ``machine_factory`` —
        how a session re-points one backend at another
        :class:`repro_torch.sched.scenario.MachineTarget` while *sharing* the
        measurement memo (safe: the fingerprint keys the timing records,
        and a target whose machine times differently yields different
        records / falls off the deterministic fast path entirely)."""
        ...


class OracleBackend:
    """Every measurement through the dataflow oracle ``Machine.run`` — the
    reference backend, and the only correct one for noisy machines or
    ``Machine`` subclasses that override ``run``."""

    name = "oracle"
    fast_measure = False
    measure_workers: Optional[int] = None

    def __init__(self, machine_factory: Callable[[], Machine] = Machine):
        self._factory = machine_factory

    def new_machine(self) -> Machine:
        return self._factory()

    def memo_view(self, program, owner: str = "") -> None:
        return None

    def time(self, program, owner: str = "") -> float:
        return self.new_machine().run(program).cycles

    def autotune_time_fn(self, owner: str = "") -> "Callable":
        # one machine across the whole grid, so a noisy machine draws
        # independent noise per config (the legacy autotune contract)
        machine = self.new_machine()
        return lambda program: machine.run(program).cycles

    def for_target(self, machine_factory: Callable[[], Machine]
                   ) -> "OracleBackend":
        return OracleBackend(machine_factory)


class FastTimingBackend:
    """Timing-only measurement behind the shared cross-kernel memo.

    Bit-exact against the oracle for the stock noise-free :class:`Machine`
    (the precondition the game itself checks); for anything else the
    backend degrades to unmemoized ``machine.time`` and the game falls back
    to its oracle path, preserving legacy behaviour exactly.
    """

    name = "fast"
    fast_measure = True
    measure_workers: Optional[int] = None

    def __init__(self, machine_factory: Callable[[], Machine] = Machine,
                 memo: Optional[SharedMeasureMemo] = None):
        self._factory = machine_factory
        self.memo = memo if memo is not None else SharedMeasureMemo()
        self._deterministic: Optional[bool] = None

    def new_machine(self) -> Machine:
        return self._factory()

    @property
    def deterministic(self) -> bool:
        """Memoization is sound iff timing is a pure function of the
        schedule — same check the game uses before enabling its fast path."""
        if self._deterministic is None:
            m = self._factory()
            self._deterministic = (m.noise == 0
                                   and type(m).run is Machine.run)
        return self._deterministic

    def memo_view(self, program, owner: str = "") -> Optional[_MemoView]:
        if not self.deterministic:
            return None
        return self.memo.view(program, owner)

    def time(self, program, owner: str = "") -> float:
        if not self.deterministic:
            return self.new_machine().time(program)
        view = self.memo.view(program, owner)
        key = np.arange(len(program), dtype=np.int64).tobytes()
        cycles = view.get(key)
        if cycles is None:
            cycles = time_program(program)
            view[key] = cycles
        return cycles

    def autotune_time_fn(self, owner: str = "") -> "Callable":
        if self.deterministic:
            return lambda program: self.time(program, owner)
        # noisy / subclassed machine: one machine across the grid so each
        # config draws fresh noise from the same stream, exactly like the
        # legacy ``autotune(..., machine=factory())`` path
        machine = self.new_machine()
        return machine.time

    def for_target(self, machine_factory: Callable[[], Machine]
                   ) -> "FastTimingBackend":
        return FastTimingBackend(machine_factory, memo=self.memo)


class PooledBackend(FastTimingBackend):
    """FastTiming plus a measurement worker pool: the batched rollout fans
    one step's distinct memo misses out over ``workers`` threads (pays off
    for timing paths that release the GIL; see ``train_on_program``)."""

    name = "pooled"

    def __init__(self, machine_factory: Callable[[], Machine] = Machine,
                 memo: Optional[SharedMeasureMemo] = None, workers: int = 4):
        super().__init__(machine_factory, memo)
        self.measure_workers = int(workers)

    def for_target(self, machine_factory: Callable[[], Machine]
                   ) -> "PooledBackend":
        return PooledBackend(machine_factory, memo=self.memo,
                             workers=self.measure_workers)


BACKENDS = {
    "oracle": OracleBackend,
    "fast": FastTimingBackend,
    "pooled": PooledBackend,
}


def make_backend(name: str, **kwargs) -> MeasureBackend:
    """CLI-facing constructor: ``make_backend("pooled", workers=8)``."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; one of {sorted(BACKENDS)}")
    return cls(**kwargs)
