"""Timing-only execution of TSASS programs — the fast reward loop.

:meth:`repro_torch.core.machine.Machine.run` is the *dataflow oracle*: it threads
64-bit hashes through a delayed-commit store so that any dependency
violation corrupts the observable outputs.  Probabilistic testing needs
that; the RL reward only reads ``RunResult.cycles``.  This module
re-implements *just* the scoreboard rules — stall counts, wait-barrier
masks, DMA engines and their queue depths, VMEM ports, MXU issue intervals
and the operand-reuse buffer — over a compact per-instruction record, and
guarantees **bit-exact** agreement with ``Machine.run(...).cycles``
(property-tested in ``tests/test_timing_fast.py``).

Entry points:

* :func:`time_program` (surfaced as ``Machine.time``) — one-shot timing of
  a program, roughly an order of magnitude cheaper per instruction than
  ``run`` (no hash mixing, no register/memory stores);
* :func:`issue_times` (surfaced as ``Machine.issue_times``) — per-
  instruction issue cycles, for clock-style microbenchmarks;
* :class:`ScheduleTimer` — the assembly game's measurement engine.  Built
  once per instruction *identity* set, it checkpoints the full scoreboard
  state every ``checkpoint_every`` positions of the last-timed order, so
  re-timing after an adjacent swap at position ``p`` resumes from the
  nearest checkpoint at or below ``p - 1`` instead of cycle 0.

Like :mod:`repro_torch.core.machine`, this module is machine-side: it may read
the private latency/bandwidth tables.  Optimizer-facing code still must
not import them (DESIGN.md §2.3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.isa import Instruction, NUM_SEMAPHORES
from repro_torch.core.machine import (_DMA_BYTES_PER_CYCLE, _DMA_QUEUE_DEPTH,
                                      _DMA_SETUP, _LDV_LAT, _MXU_ISSUE_INTERVAL,
                                      _MXU_REUSE_INTERVAL, _NUM_IN_ENGINES,
                                      _VMEM_PORT_HOLD, _VMEM_PORTS, _dma_bytes)

# Timing kinds: one per distinct scoreboard rule set.  PLAIN covers every
# instruction whose only timing effects are its wait mask and stall count
# (scalar/vector/MXU-free ops, NOP, SCLK, EXIT/BRA, and anything
# predicated off — ``@!PT`` never executes, so no hazards or effects).
_PLAIN, _MXM, _CPYIN, _CPYOUT, _LDV, _STV, _SEMWAIT, _LABEL = range(8)


def time_record(ins: Instruction) -> tuple:
    """The per-instruction timing record, computed once and cached on the
    instruction object (instructions are immutable during games; only their
    order changes — the same contract as ``machine.exec_info``).

    Layout: ``(kind, wait_tuple, step, dma_cycles, write_bar, read_bar,
    reuse_flag, uses_frozenset)`` with ``-1`` for absent barriers.
    """
    rec = getattr(ins, "_trec", None)
    if rec is not None:
        return rec
    base = ins.base
    if base == "LABEL":
        kind = _LABEL
    elif ins.predicated_off():
        kind = _PLAIN
    elif base == "MXM":
        kind = _MXM
    elif base == "CPYIN":
        kind = _CPYIN
    elif base == "CPYOUT":
        kind = _CPYOUT
    elif base == "LDV":
        kind = _LDV
    elif base == "STV":
        kind = _STV
    elif base == "SEMWAIT":
        kind = _SEMWAIT
    else:
        kind = _PLAIN
    ctrl = ins.ctrl
    dma_cycles = (_dma_bytes(ins.opcode) / _DMA_BYTES_PER_CYCLE
                  if kind in (_CPYIN, _CPYOUT) else 0.0)
    rec = (kind,
           tuple(ctrl.wait_mask),
           max(1, ctrl.stall),
           dma_cycles,
           -1 if ctrl.write_bar is None else ctrl.write_bar,
           -1 if ctrl.read_bar is None else ctrl.read_bar,
           (any(".reuse" in op for op in ins.operands)
            if kind == _MXM else False),
           frozenset(ins.uses or ()) if kind == _MXM else frozenset())
    ins._trec = rec
    return rec


class _State:
    """Full scoreboard state between instructions.  Snapshots (``freeze``)
    are the ScheduleTimer's checkpoints; DMA completion queues are pruned
    against the current time when frozen — ``t`` is monotonic, so entries
    at or before it can never influence a later queue-depth stall."""

    __slots__ = ("t", "end", "sem", "in_free", "out_free", "in_q", "out_q",
                 "vp", "mxu_ready", "last_srcs", "dma_since", "next_in")

    def __init__(self):
        self.t = 0.0
        self.end = 0.0
        self.sem = [0.0] * NUM_SEMAPHORES
        self.in_free = [0.0] * _NUM_IN_ENGINES
        self.out_free = 0.0
        self.in_q: List[List[float]] = [[] for _ in range(_NUM_IN_ENGINES)]
        self.out_q: List[float] = []
        self.vp = [0.0] * _VMEM_PORTS
        self.mxu_ready = 0.0
        self.last_srcs: frozenset = frozenset()
        self.dma_since = False
        self.next_in = 0

    def freeze(self) -> tuple:
        t = self.t
        return (t, self.end, tuple(self.sem), tuple(self.in_free),
                self.out_free,
                tuple(tuple(d for d in q if d > t) for q in self.in_q),
                tuple(d for d in self.out_q if d > t),
                tuple(self.vp), self.mxu_ready, self.last_srcs,
                self.dma_since, self.next_in)

    @classmethod
    def thaw(cls, snap: tuple) -> "_State":
        st = cls.__new__(cls)
        (st.t, st.end, sem, in_free, st.out_free, in_q, out_q, vp,
         st.mxu_ready, st.last_srcs, st.dma_since, st.next_in) = snap
        st.sem = list(sem)
        st.in_free = list(in_free)
        st.in_q = [list(q) for q in in_q]
        st.out_q = list(out_q)
        st.vp = list(vp)
        return st


def _advance(st: _State, recs, order, lo: int, hi: int,
             issues: Optional[list] = None) -> None:
    """Advance positions ``[lo, hi)`` of ``order`` (identity indices into
    ``recs``), mutating ``st`` in place.

    Every arithmetic step mirrors ``Machine.run`` operation-for-operation
    so the resulting floats are identical, with one representation change:
    per-engine DMA completion times are nondecreasing, so the queues stay
    sorted and the queue-depth stall (``while len([d for d in q if d > t])
    >= DEPTH: t = min(...)``) reduces to popping the sorted head.
    """
    t = st.t
    end = st.end
    sem = st.sem
    in_free = st.in_free
    out_free = st.out_free
    in_q = st.in_q
    out_q = st.out_q
    vp = st.vp
    mxu_ready = st.mxu_ready
    last_srcs = st.last_srcs
    dma_since = st.dma_since
    next_in = st.next_in

    for x in range(lo, hi):
        kind, waits, step, dma_cycles, wbar, rbar, reuse, uses = \
            recs[order[x]]
        if kind == _LABEL:
            if issues is not None:
                issues.append(t)
            continue

        for s in waits:
            b = sem[s]
            if b > t:
                t = b

        if kind == _PLAIN:
            issue = t

        elif kind == _CPYIN:
            q = in_q[next_in]
            while q and q[0] <= t:
                del q[0]
            while len(q) >= _DMA_QUEUE_DEPTH:
                t = q[0]
                while q and q[0] <= t:
                    del q[0]
            issue = t
            eng = next_in
            next_in = (next_in + 1) % _NUM_IN_ENGINES
            start = issue + _DMA_SETUP
            free = in_free[eng]
            if free > start:
                start = free
            done = start + dma_cycles
            in_free[eng] = done
            q.append(done)
            dma_since = True
            if wbar >= 0 and done > sem[wbar]:
                sem[wbar] = done
            if rbar >= 0 and start > sem[rbar]:
                sem[rbar] = start

        elif kind == _CPYOUT:
            q = out_q
            while q and q[0] <= t:
                del q[0]
            while len(q) >= _DMA_QUEUE_DEPTH:
                t = q[0]
                while q and q[0] <= t:
                    del q[0]
            issue = t
            start = issue + _DMA_SETUP
            if out_free > start:
                start = out_free
            done = start + dma_cycles
            out_free = done
            q.append(done)
            dma_since = True
            if wbar >= 0 and done > sem[wbar]:
                sem[wbar] = done
            if rbar >= 0 and start > sem[rbar]:
                sem[rbar] = start

        elif kind == _LDV or kind == _STV:
            p = 0
            for i in range(1, _VMEM_PORTS):
                if vp[i] < vp[p]:
                    p = i
            free = vp[p]
            if free > t:
                t = free
            vp[p] = t + _VMEM_PORT_HOLD
            issue = t
            if kind == _LDV:
                done = issue + _LDV_LAT
                if wbar >= 0 and done > sem[wbar]:
                    sem[wbar] = done
            else:
                rdone = issue + 2
                if rbar >= 0 and rdone > sem[rbar]:
                    sem[rbar] = rdone

        elif kind == _MXM:
            if mxu_ready > t:
                t = mxu_ready
            issue = t
            if reuse and not dma_since and (uses & last_srcs):
                mxu_ready = issue + _MXU_REUSE_INTERVAL
            else:
                mxu_ready = issue + _MXU_ISSUE_INTERVAL
            last_srcs = uses
            dma_since = False

        else:  # _SEMWAIT
            for b in sem:
                if b > t:
                    t = b
            issue = t

        if issues is not None:
            issues.append(issue)
        t = issue + step
        if t > end:
            end = t

    st.t = t
    st.end = end
    st.out_free = out_free
    st.mxu_ready = mxu_ready
    st.last_srcs = last_srcs
    st.dma_since = dma_since
    st.next_in = next_in


def _finalize(st: _State) -> float:
    """The program's cycle count from a fully-advanced state (matches the
    oracle's ``end = max([end, out_engine_free] + in_engine_free +
    sem_busy)``).  Read-only: the state stays resumable."""
    end = st.end
    if st.out_free > end:
        end = st.out_free
    for v in st.in_free:
        if v > end:
            end = v
    for v in st.sem:
        if v > end:
            end = v
    return float(end)


def time_program(program: Sequence[Instruction]) -> float:
    """Cycle count of ``program`` via the timing-only executor.  Bit-exact
    against ``Machine().run(program).cycles``."""
    recs = [time_record(ins) for ins in program]
    st = _State()
    _advance(st, recs, range(len(recs)), 0, len(recs))
    return _finalize(st)


def issue_times(program: Sequence[Instruction]) -> List[float]:
    """Per-instruction issue cycles (LABELs report the running cycle
    count).  The timing-only route for clock-style measurements: an
    ``SCLK`` destination register holds ``int(issue)``."""
    recs = [time_record(ins) for ins in program]
    st = _State()
    issues: List[float] = []
    _advance(st, recs, range(len(recs)), 0, len(recs), issues=issues)
    return issues


class ScheduleTimer:
    """Incremental, checkpointed timing over permutations of one
    instruction set — the assembly game's measurement engine.

    ``time_ids(order)`` times ``[instructions[i] for i in order]``.  The
    scoreboard state is checkpointed every ``checkpoint_every`` positions
    of the most recently timed order; a new order that shares a prefix
    (an adjacent swap at position ``p`` first differs at ``p - 1``)
    resumes from the nearest checkpoint at or below the first difference
    instead of from cycle 0, and rewrites only the checkpoints it
    invalidates.

    ``recs`` — the stall counts, wait masks, DMA durations and op kinds
    compiled once per instruction identity — is the program representation
    the interpreter loop runs on; positions only index into it.
    """

    def __init__(self, instructions: Sequence[Instruction],
                 checkpoint_every: int = 16):
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.recs = [time_record(ins) for ins in instructions]
        self.n = len(self.recs)
        self.k = int(checkpoint_every)
        self._last: Optional[np.ndarray] = None      # last timed order
        self._last_cycles: Optional[float] = None
        self._ckpts: List[tuple] = []                # [j] = state before j*k
        self.resumed_from = 0                        # diagnostics

    def time_ids(self, ids) -> float:
        """Cycles for the order ``ids`` (identity indices).  Bit-exact
        against timing the permuted program from scratch."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.shape[0] != self.n:
            raise ValueError(
                f"order length {ids.shape[0]} != program length {self.n}")
        if self._last is not None:
            if np.array_equal(ids, self._last):
                self.resumed_from = self.n
                return self._last_cycles
            first = int(np.argmax(ids != self._last))
        else:
            first = 0

        ci = min(first // self.k, len(self._ckpts) - 1)
        if ci < 0:
            st = _State()
            pos = 0
            self._ckpts = []
        else:
            st = _State.thaw(self._ckpts[ci])
            pos = ci * self.k
            del self._ckpts[ci + 1:]
        self.resumed_from = pos

        order = ids.tolist()
        recs = self.recs
        k = self.k
        n = self.n
        while pos < n:
            if pos // k == len(self._ckpts):
                self._ckpts.append(st.freeze())
            nxt = pos + k
            if nxt > n:
                nxt = n
            _advance(st, recs, order, pos, nxt)
            pos = nxt

        self._last = ids.copy()
        self._last_cycles = _finalize(st)
        return self._last_cycles

    def time_many(self, orders) -> List[float]:
        """Cycles for a batch of orders in one pass — the vectorized
        rollout's measurement path.

        The orders of one rollout step are near-permutations of each other
        (every env applied one adjacent swap to a shared-prefix
        trajectory), so they are grouped by sorting on their byte strings:
        lexicographic neighbors share the longest prefixes, which means
        each successive :meth:`time_ids` call resumes from the nearest
        shared checkpoint instead of cycle 0 — the suffix after the first
        divergence is all that gets re-timed.  Results come back in the
        input order; each is bit-exact against timing that order alone.
        """
        orders = [np.asarray(o, dtype=np.int64) for o in orders]
        by_prefix = sorted(range(len(orders)),
                           key=lambda i: orders[i].tobytes())
        out: List[Optional[float]] = [None] * len(orders)
        for i in by_prefix:
            out[i] = self.time_ids(orders[i])
        return out
