"""Profiler spans and host counters at the train step's layer boundaries.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
torch profiler records, and returns a shared no-op context otherwise:
tracing is on exactly when a profiler records, and an untraced step
pays one check a span.  The spans are profiler ranges, so they share
the profile's clock with the device activities it records.  A kernel
belongs to the innermost span open on the thread that launched it, and
a backward node to the span around the forward operator that made it
(the profile gives the node's events that operator's ``sequence_nr``
and ``fwd_thread``).

:func:`recompute` marks the forward that a checkpoint runs again in the
backward pass (``models/lm.py::_remat``); the layer spans open again
inside it.  ``count(name, n)`` adds ``n`` to a host counter under the
same condition as ``span``, and never inside :func:`recompute`, so a
counter counts each layer's forward once a step.  :func:`counters`
reads the counters and :func:`reset` clears them.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict

import torch
from torch.profiler import record_function

ATTN = "repro_torch.attn"
NORM = "repro_torch.norm"
MLP = "repro_torch.mlp"
MOE_ROUTER = "repro_torch.moe.router"
MOE_EXPERTS = "repro_torch.moe.experts"
EMBED = "repro_torch.embed"
HEAD = "repro_torch.head"
LOSS = "repro_torch.loss"
OPTIM = "repro_torch.optim"
RECOMPUTE = "repro_torch.recompute"

_NOOP = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


class _Local(threading.local):
    recomputing = 0


_local = _Local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    no-op context."""
    return record_function(name) if _recording() else _NOOP


@contextlib.contextmanager
def _recompute():
    _local.recomputing += 1
    try:
        with record_function(RECOMPUTE):
            yield
    finally:
        _local.recomputing -= 1


def recompute():
    """The span of a layer's second forward, run by its checkpoint in the
    backward pass; no counter counts inside it."""
    return _recompute() if _recording() else _NOOP


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler records, outside
    :func:`recompute`."""
    if _recording() and not _local.recomputing:
        with _lock:
            _counts[name] += int(n)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
