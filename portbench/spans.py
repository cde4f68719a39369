"""Device time of a traced run's steps by the port's own spans.

The port opens ``repro_torch.<layer>`` profiler ranges at the train
step's layer boundaries (``repro_torch/utils/spans.py``).  :func:`split`
reads the host events of a :class:`portbench.trace.Trace` once and keeps
the result on it:

* a kernel (copy, fill) belongs to the innermost program span around
  the host event that launched it (its *owner*); kernels no program
  span claims belong to None, the step's unspanned rest;
* a backward event (``autograd::engine::evaluate_function: <Node>``,
  and the node's own event) carries the ``fwd_thread`` and
  ``sequence_nr`` of the forward operator that made the node, and takes
  that operator's owner; of the forward events of one thread and
  sequence number, the one that started last made the node (the rule by
  which PyTorch's profiler links forward and backward);
* a span open inside a backward event wins over the backward link:
  ``repro_torch.recompute``, the forward a checkpoint runs again in the
  backward pass, owns nothing itself (its kernels outside a layer span
  are unspanned, as in the forward) and marks every kernel inside it,
  the layer spans within it owning theirs;
* a step's work is every event, on any thread, that starts inside one
  of the window's ``portbench.step`` spans, and each kernel is counted
  once, on the event that launched it: the profiler attaches a kernel
  to every host event of its correlation id, and CUPTI's own events
  inside an operator (``Command Buffer Full`` where a launch waited for
  room in the queue) share the operator's id, so an id's kernels count
  once.

So the owners' times sum to the device time of the kernels launched in
the steps.  The spans' own images on the device's timeline are no
work and are left out, as :mod:`portbench.trace` leaves them out.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

PREFIX = "repro_torch."
RECOMPUTE = PREFIX + "recompute"
STEP = "portbench.step"
EVALUATE = "autograd::engine::evaluate_function: "
ANNOTATIONS = (PREFIX, "portbench.")


@dataclasses.dataclass
class Split:
    steps: int
    us: Dict[Optional[str], float]   # device microseconds by owner
    recompute_us: float
    seen: FrozenSet[str]             # the program spans in the steps
    by_node: Dict[Tuple[str, Optional[str]], float]  # (backward node, owner)
    seconds: float                   # this attribution's own time
    _owners: List[Tuple[float, float, Optional[str]]]

    def ms_per_step(self, *owners) -> float:
        return sum(self.us.get(o, 0.0) for o in owners) / 1e3 / self.steps


def _backward(e) -> bool:
    return e.fwd_thread > 0 and e.sequence_nr >= 0


class _Owners:
    """Each event's owner and whether a recompute encloses it."""

    def __init__(self, events):
        self.fwd = {}
        for e in events:
            if e.sequence_nr >= 0 and not _backward(e):
                key = (e.thread, e.sequence_nr)
                old = self.fwd.get(key)
                if old is None or e.time_range.start >= old.time_range.start:
                    self.fwd[key] = e
        self.memo: Dict[int, Tuple[Optional[str], bool]] = {}

    def of(self, e) -> Tuple[Optional[str], bool]:
        """(owner, inside a recompute) of event ``e``."""
        chain = []
        while e is not None and id(e) not in self.memo:
            chain.append(e)
            e = e.cpu_parent
        below = self.memo[id(e)] if e is not None else (None, False)
        for e in reversed(chain):
            owner, rec = below
            if e.name == RECOMPUTE:
                owner, rec = None, True
            elif e.name.startswith(PREFIX):
                owner = e.name
            elif _backward(e):
                op = self.fwd.get((e.fwd_thread, e.sequence_nr))
                owner = self.of(op)[0] if op is not None else None
            below = self.memo[id(e)] = (owner, rec)
        return below


def _steps(trace) -> List[Tuple[float, float]]:
    return sorted((e.time_range.start, e.time_range.end) for e in trace.host
                  if e.name == STEP and trace.t0 <= e.time_range.start
                  < trace.t1)


def split(trace) -> Split:
    """The attribution of ``trace``'s steps, computed once a trace."""
    cached = getattr(trace, "_portbench_spans", None)
    if cached is not None:
        return cached
    t = time.perf_counter()
    steps = _steps(trace)
    starts = [a for a, _ in steps]

    def in_step(s: float) -> bool:
        i = bisect.bisect_right(starts, s) - 1
        return i >= 0 and s < steps[i][1]

    events = [e for e in trace.host if in_step(e.time_range.start)]
    owners = _Owners(events)
    us: Dict[Optional[str], float] = {}
    by_node: Dict[Tuple[str, Optional[str]], float] = {}
    seen = set()
    intervals = []
    recompute_us = 0.0
    counted = set()
    for e in events:
        owner, rec = owners.of(e)
        if e.name.startswith(PREFIX):
            seen.add(e.name)
        intervals.append((e.time_range.start, e.time_range.end, owner))
        if not e.kernels or e.id in counted:
            continue
        counted.add(e.id)
        k_us = sum(k.duration for k in e.kernels
                   if not k.name.startswith(ANNOTATIONS))
        if k_us <= 0:
            continue
        us[owner] = us.get(owner, 0.0) + k_us
        if rec:
            recompute_us += k_us
        node = _node(e)
        if node is not None:
            by_node[node, owner] = by_node.get((node, owner), 0.0) + k_us
    out = Split(steps=len(steps), us=us, recompute_us=recompute_us,
                seen=frozenset(seen), by_node=by_node,
                seconds=time.perf_counter() - t, _owners=intervals)
    trace._portbench_spans = out
    return out


def _node(e) -> Optional[str]:
    """The backward node whose evaluation encloses ``e``, if any."""
    while e is not None:
        if e.name.startswith(EVALUATE):
            return e.name[len(EVALUATE):]
        e = e.cpu_parent
    return None


def of(rec) -> Optional[Split]:
    """The run's attribution; None without a trace or without any
    program span in its steps (a program that opens none)."""
    if rec.trace is None:
        return None
    s = split(rec.trace)
    return s if s.seen and s.steps else None


def ms_per_step(rec, *spans: str) -> Optional[float]:
    """Device ms a window step owned by ``spans``; None where none of
    them opened in the steps."""
    s = of(rec)
    if s is None or not s.seen & set(spans):
        return None
    return s.ms_per_step(*spans)


def idle_by_span(trace) -> Dict[Optional[str], float]:
    """Seconds of the steps' idle device time by the owner of the
    innermost host event open (on any thread) where each idle gap
    starts: what the host was doing while the device waited."""
    s = split(trace)
    steps = _steps(trace)
    gaps = []
    prev = None
    for a, b in trace.busy:
        if prev is not None and a > prev:
            gaps.append((prev, a))
        prev = b
    gaps = [(a, b) for a, b in gaps
            if any(lo <= a < hi for lo, hi in steps)]
    events = sorted(s._owners, key=lambda x: x[0])
    out: Dict[Optional[str], float] = {}
    # the open event that started last, the shorter first on a tie
    heap: List[Tuple[float, float, int, Optional[str]]] = []
    i = 0
    for a, b in gaps:
        while i < len(events) and events[i][0] <= a:
            start, end, owner = events[i]
            heapq.heappush(heap, (-start, end, i, owner))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        owner = heap[0][3] if heap else None
        out[owner] = out.get(owner, 0.0) + (b - a) / 1e6
    return out
