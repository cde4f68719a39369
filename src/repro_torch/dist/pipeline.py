"""Pipeline schedules over a ``pipe`` mesh axis.

Port of ``repro/dist/pipeline.py``.  A :class:`PipelineSchedule` is a
*schedule table*: for every clock tick it says which ``(microbatch,
stage, phase)`` micro-ops run, with ``phase`` one of ``"F"`` (forward) /
``"B"`` (backward).  The table is the single source of truth for:

* **execution** — :meth:`PipelineSchedule.run_local` streams the forward
  micro-ops on every rank of the ``pipe`` axis (one process per rank);
  activations hop between stages through a ring
  :func:`repro_torch.dist.collectives.ppermute`, and the backward ops are
  realized by autograd transposing the forward stream (the permutation's
  backward is the inverse ring), so the table's ``B`` entries describe
  when a real pipelined runtime would retire each microbatch's
  activations;
* **memory accounting** — :meth:`peak_live_microbatches` simulates the
  table (``F`` allocates one stage-activation, ``B`` frees it).  GPipe
  holds all ``M`` microbatches live; 1F1B bounds the peak at ``min(S,
  M)``;
* **analysis** — :meth:`bubble_fraction`.

Two implementations, :class:`GPipeSchedule` (fill/steady/drain) and
:class:`OneFOneBSchedule` (PipeDream-flush 1F1B).  Both push every
microbatch through the same per-stage math in the same microbatch order,
so their losses and gradients agree exactly.

The runners keep the reference's SPMD form: every rank calls
``stage_fn`` on every row, idle rows compute on don't-care data that is
masked out with ``torch.where`` on a per-rank condition tensor, and
every collective's output feeds the loss on every rank.  So every rank
builds the same autograd graph and issues the same collectives, in
forward and in backward, in the same order; a rank that skipped an idle
row would leave its peers waiting in the backward ring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.dist import collectives as col
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class MicroOp:
    """One cell of the schedule table: at ``tick``, ``stage`` runs the
    ``phase`` ("F"/"B") pass of ``micro``."""
    tick: int
    stage: int
    micro: int
    phase: str


def _table_to_fwd_rows(table: Sequence[MicroOp], n_stages: int
                       ) -> List[Tuple[int, ...]]:
    """Compress the table to forward-only rows for the SPMD runner: one row
    per tick that contains at least one ``F`` op; ``row[s]`` is the micro
    stage ``s`` forwards that tick (``-1`` = idle).  Dropping forward-empty
    ticks (pure-backward slots — autograd's transpose runs them, not the
    primal loop) preserves the relative order of every ``F`` op, which is
    all the ring transfer needs."""
    by_tick: Dict[int, Dict[int, int]] = {}
    for op in table:
        if op.phase == "F":
            by_tick.setdefault(op.tick, {})[op.stage] = op.micro
    rows = []
    for t in sorted(by_tick):
        row = tuple(by_tick[t].get(s, -1) for s in range(n_stages))
        rows.append(row)
    # the ring buffer's `micro % capacity` slot assignment is collision-free
    # only while every stage consumes micros in increasing order (the live
    # set is then a contiguous window).  gpipe and 1F1B satisfy this; an
    # interleaved/virtual-stage schedule would not — fail loudly instead of
    # silently training on an aliased activation.
    last = [-1] * n_stages
    for row in rows:
        for s, m in enumerate(row):
            if m >= 0:
                if m <= last[s]:
                    raise ValueError(
                        f"schedule forwards micro {m} on stage {s} after "
                        f"micro {last[s]}: non-monotone forward order is "
                        "not supported by the ring-buffer runner")
                last[s] = m
    return rows


def _ring_capacity(rows: Sequence[Tuple[int, ...]], n_stages: int) -> int:
    """Minimal per-rank activation-buffer capacity for the runner: the max
    number of microbatches simultaneously resident on any stage (received
    from the predecessor but not yet consumed).  Micros arrive in order, so
    ``micro % capacity`` slots never collide at this capacity."""
    cap = 1
    for s in range(1, n_stages):
        produced = {}
        consumed = {}
        for t, row in enumerate(rows):
            if row[s - 1] >= 0:
                produced[row[s - 1]] = t
            if row[s] >= 0:
                consumed[row[s]] = t
        for t in range(len(rows)):
            live = sum(1 for m, pt in produced.items()
                       if pt < t <= consumed.get(m, -1))
            cap = max(cap, live)
    return cap


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    """A 0-d bool tensor on ``like``'s device: a per-rank condition for
    ``torch.where`` (every rank then builds the same graph)."""
    return torch.tensor(bool(value), device=like.device)


def _run_fwd_rows(rows: Sequence[Tuple[int, ...]], stage_fn, stage_weights,
                  microbatches, *, n_stages: int, axis,
                  replicate_out: bool):
    """Execute a forward row table on this rank of ``axis`` (a bound
    :class:`repro_torch.dist.collectives.Axis`).  Same SPMD shape as
    :func:`gpipe_local` — every rank calls ``stage_fn`` every row (idle
    ranks compute on don't-care data whose outputs are masked out of the
    buffer/output writes, so their cotangents are exactly zero) — but
    produce→consume gaps larger than one tick are carried in a bounded
    ring buffer instead of a single ``recv`` slot."""
    n_micro = microbatches.shape[0]
    stage = axis.index
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    cap = _ring_capacity(rows, n_stages)
    is_first = _flag(stage == 0, microbatches)
    is_last = _flag(stage == n_stages - 1, microbatches)
    buf = microbatches.new_zeros((cap,) + microbatches.shape[1:])
    outs = [torch.zeros_like(microbatches[0])] * n_micro
    recv = torch.zeros_like(microbatches[0])
    for t, row in enumerate(rows):
        if t > 0:
            # bank the activation ppermuted in at the end of the previous
            # row under the *sender's* micro index (static per stage)
            prev = rows[t - 1]
            recv_micro = prev[stage - 1] if stage > 0 else -1
            slot = torch.arange(cap, device=buf.device) \
                == max(recv_micro, 0) % cap
            write = (slot & _flag(recv_micro >= 0, buf)).reshape(
                (cap,) + (1,) * recv.ndim)
            buf = torch.where(write, recv[None], buf)
        idx = max(row[stage], 0)
        x0 = microbatches[min(idx, n_micro - 1)]
        xb = buf[idx % cap]
        inp = torch.where(is_first, x0, xb)
        y = stage_fn(stage_weights, inp)
        m_last = row[n_stages - 1]
        if m_last >= 0:  # the last stage finished microbatch m_last
            outs[m_last] = torch.where(is_last, y, outs[m_last])
        if t < len(rows) - 1:
            recv = col.ppermute(y, axis, perm)
    out = torch.stack(outs)
    out = torch.where(is_last, out, torch.zeros_like(out))
    if replicate_out:
        out = col.psum(out, axis)
    return out


class PipelineSchedule:
    """Base schedule: subclasses define :meth:`table`; execution, memory
    accounting and bubble analysis derive from it."""

    name: str = "abstract"

    def table(self, n_micro: int, n_stages: int) -> List[MicroOp]:
        raise NotImplementedError

    def forward_rows(self, n_micro: int, n_stages: int
                     ) -> List[Tuple[int, ...]]:
        """Forward-only rows for the SPMD runner (one row per tick that
        forwards anything; ``row[s]`` = micro or -1)."""
        return _table_to_fwd_rows(self.table(n_micro, n_stages), n_stages)

    def peak_live_microbatches(self, n_micro: int, n_stages: int) -> int:
        """Max microbatch activations simultaneously live on any stage
        (``F`` allocates, ``B`` frees — the classic pipeline memory
        model)."""
        live = [0] * n_stages
        peak = 0
        for op in sorted(self.table(n_micro, n_stages),
                         key=lambda o: o.tick):
            live[op.stage] += 1 if op.phase == "F" else -1
            peak = max(peak, live[op.stage])
        return peak

    def bubble_fraction(self, n_micro: int, n_stages: int) -> float:
        """Idle fraction of the busiest-possible schedule: 1 - useful ops /
        (stages × total ticks)."""
        table = self.table(n_micro, n_stages)
        ticks = max(op.tick for op in table) + 1
        return 1.0 - len(table) / float(n_stages * ticks)

    def run_local(self, stage_fn, stage_weights, microbatches, *,
                  n_stages: int, axis, replicate_out: bool = True):
        """Run the schedule's forward stream on this rank of ``axis`` (same
        contract as :func:`gpipe_local`)."""
        return _run_fwd_rows(
            self.forward_rows(microbatches.shape[0], n_stages),
            stage_fn, stage_weights, microbatches,
            n_stages=n_stages, axis=axis, replicate_out=replicate_out)

    def run(self, stage_fn, stage_weights, microbatches, mesh,
            axis: str = "pipe"):
        """Standalone entry point, the reference's ``shard_map`` wrapper:
        ``stage_weights`` are stacked ``(S, ...)`` over the stages (each
        rank takes its own block, ``P(axis)``), ``microbatches`` are
        replicated, and every rank returns the final stage's outputs."""
        bound = mesh.axis(axis)
        n_stages = bound.size
        lead = tree_leaves(stage_weights)[0].shape[0]
        assert lead == n_stages, (
            f"{self.name}: got {lead} stage weights for a "
            f"{n_stages}-way '{axis}' axis")
        w = tree_map(lambda a: a[bound.index], stage_weights)
        return self.run_local(stage_fn, w, microbatches, n_stages=n_stages,
                              axis=bound)


class GPipeSchedule(PipelineSchedule):
    """Classic fill/steady/drain: all forwards, then all backwards.
    ``run_local`` is the :func:`gpipe_local` loop."""

    name = "gpipe"

    def table(self, n_micro: int, n_stages: int) -> List[MicroOp]:
        ops = [MicroOp(s + m, s, m, "F")
               for s in range(n_stages) for m in range(n_micro)]
        t_fwd = n_micro + n_stages - 1  # every forward done before any B
        ops += [MicroOp(t_fwd + (n_stages - 1 - s) + (n_micro - 1 - m),
                        s, m, "B")
                for s in range(n_stages) for m in range(n_micro)]
        return ops

    def run_local(self, stage_fn, stage_weights, microbatches, *,
                  n_stages: int, axis, replicate_out: bool = True):
        return gpipe_local(stage_fn, stage_weights, microbatches,
                           n_stages=n_stages, axis=axis,
                           replicate_out=replicate_out)


class OneFOneBSchedule(PipelineSchedule):
    """PipeDream-flush 1F1B: bounded in-flight activations.

    Per stage ``s``: ``min(S - s - 1, M)`` warmup forwards, then strict
    one-forward/one-backward alternation, then the remaining backwards.
    Tick placement comes from a greedy list-scheduling pass over the
    dependency DAG (``F(s, m)`` after ``F(s-1, m)``; ``B(s, m)`` after
    ``B(s+1, m)`` and, on the last stage, after ``F(S-1, m)``; one op per
    stage per tick) — the standard synchronous 1F1B timetable."""

    name = "1f1b"

    def table(self, n_micro: int, n_stages: int) -> List[MicroOp]:
        seqs = []
        for s in range(n_stages):
            warmup = min(n_stages - s - 1, n_micro)
            seq = [("F", m) for m in range(warmup)]
            b = 0
            for m in range(warmup, n_micro):
                seq.append(("F", m))
                seq.append(("B", b))
                b += 1
            seq += [("B", m) for m in range(b, n_micro)]
            seqs.append(seq)

        ptr = [0] * n_stages
        done: Dict[tuple, int] = {}
        ops: List[MicroOp] = []
        total = sum(len(q) for q in seqs)
        t = 0
        while len(ops) < total:
            if t > 4 * (n_micro + n_stages) + 8:
                raise RuntimeError(
                    f"1f1b schedule did not converge for M={n_micro}, "
                    f"S={n_stages}")  # pragma: no cover - scheduler bug net
            for s in range(n_stages):
                if ptr[s] >= len(seqs[s]):
                    continue
                phase, m = seqs[s][ptr[s]]
                if phase == "F":
                    ready = s == 0 or done.get(("F", s - 1, m), t) < t
                elif s == n_stages - 1:
                    ready = done.get(("F", s, m), t) < t
                else:
                    ready = done.get(("B", s + 1, m), t) < t
                if ready:
                    done[(phase, s, m)] = t
                    ops.append(MicroOp(t, s, m, phase))
                    ptr[s] += 1
            t += 1
        return ops


SCHEDULES = {
    "gpipe": GPipeSchedule,
    "1f1b": OneFOneBSchedule,
}


def get_schedule(name) -> PipelineSchedule:
    """Resolve a schedule by name (or pass a :class:`PipelineSchedule`
    instance through).  Raises ``ValueError`` listing the valid choices —
    launchers surface this eagerly, before any step runs."""
    if isinstance(name, PipelineSchedule):
        return name
    try:
        return SCHEDULES[name]()
    except KeyError:
        raise ValueError(
            f"unknown pipeline schedule {name!r}; valid choices: "
            f"{sorted(SCHEDULES)}") from None


# ---------------------------------------------------------------------------
# the gpipe loop
# ---------------------------------------------------------------------------

def gpipe_local(stage_fn, stage_weights, microbatches, *, n_stages: int,
                axis, replicate_out: bool = True):
    """Run the gpipe fill/steady/drain schedule on this rank of ``axis``.

    Args:
      stage_fn: ``(w, x) -> y`` for this rank's stage; ``x``/``y`` shaped
        like one microbatch ``(mb, ...)``.
      stage_weights: this rank's stage weights, handed to ``stage_fn``
        unchanged.
      microbatches: ``(M, mb, ...)`` tensor, the same on every rank of
        ``axis`` (only stage 0 reads it).
      n_stages: size of ``axis``.
      axis: the pipeline axis, a bound
        :class:`repro_torch.dist.collectives.Axis`.
      replicate_out: when True, psum-replicate the final-stage outputs to
        every rank; when False, return them only on the last stage (zeros
        elsewhere) — callers computing a loss mask it to the last stage so
        gradients are not over-counted ``n_stages`` times.

    Returns:
      ``(M, mb, ...)`` outputs of the final stage.
    """
    n_micro = microbatches.shape[0]
    stage = axis.index
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    is_first = _flag(stage == 0, microbatches)
    is_last = _flag(stage == n_stages - 1, microbatches)
    outs = [torch.zeros_like(microbatches[0])] * n_micro
    recv = torch.zeros_like(microbatches[0])
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t during the fill phase; every other
        # stage consumes what its predecessor sent last step
        inp = torch.where(is_first, microbatches[min(t, n_micro - 1)], recv)
        y = stage_fn(stage_weights, inp)
        m = t - (n_stages - 1)
        if m >= 0:  # drain: the last stage owns finished microbatch m
            outs[m] = torch.where(is_last, y, outs[m])
        if t < n_micro + n_stages - 2:
            recv = col.ppermute(y, axis, perm)
    # only the last stage holds real outputs
    out = torch.stack(outs)
    out = torch.where(is_last, out, torch.zeros_like(out))
    if replicate_out:
        # psum replicates them (every other rank contributes zeros)
        out = col.psum(out, axis)
    return out


def gpipe(stage_fn, stage_weights, microbatches, mesh, axis: str = "pipe"):
    """Pipeline-parallel application of ``S`` sequential stages with the
    gpipe schedule (the standalone form; see :meth:`PipelineSchedule.run`
    for the schedule-generic one)."""
    return GPipeSchedule().run(stage_fn, stage_weights, microbatches, mesh,
                               axis=axis)
