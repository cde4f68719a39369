"""What a traced run reads from ``torch.profiler``.

The driver profiles its measured window (CPU and CUDA activities, with
input shapes) inside a ``portbench.window`` span, and marks each step's
parts with the benchmark's own spans (``portbench.input``,
``portbench.step``, ``portbench.sync``).  :class:`Trace` keeps, in the
profiler's microseconds:

* the window's interval;
* every device activity (kernels, copies, fills) as (start, end, name),
  leaving out the spans' images on the device's timeline;
* the host's operator events, with each operator's input shapes and the
  device time of the kernels it launched.

The device is busy where any activity runs (the union of their
intervals, clipped to the window); the rest of the window is idle.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Tuple

WINDOW = "portbench.window"
SPANS = ("portbench.input", "portbench.step", "portbench.sync")
NAME_CHARS = 160    # a kernel's name as the breakdown gives it


class EmptyTrace(RuntimeError):
    """The profile holds no device activity in the window."""


def _annotation(event) -> bool:
    """A span's image on the device's timeline (``record_function``
    ranges appear there too), not work the device did."""
    return bool(getattr(event, "is_user_annotation", False)) \
        or event.name.startswith("portbench.")


def _kernel_us(event) -> float:
    """Device microseconds of the kernels ``event`` and the operators it
    called launched."""
    total = sum(k.duration for k in getattr(event, "kernels", ()))
    return total + sum(_kernel_us(c) for c in event.cpu_children)


class Trace:
    def __init__(self, events):
        from torch.autograd import DeviceType
        host = [e for e in events if e.device_type == DeviceType.CPU]
        windows = [e for e in host if e.name == WINDOW]
        if not windows:
            raise EmptyTrace(f"no {WINDOW} span in the profile")
        self.t0 = windows[0].time_range.start
        self.t1 = windows[0].time_range.end
        self.device = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CUDA and not _annotation(e)
            and e.time_range.end > self.t0 and e.time_range.start < self.t1)
        if not self.device:
            raise EmptyTrace("the profile holds no device activity in the "
                             "window")
        self.host = host
        self.busy = self._merge()

    def _merge(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for start, end, _ in self.device:
            start, end = max(start, self.t0), min(end, self.t1)
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def op_calls(self, name: str) -> List[Tuple[object, float]]:
        """(event, device microseconds of its kernels) of each call of the
        operator ``name`` in the window."""
        return [(e, _kernel_us(e)) for e in self.host if e.name == name
                and self.t0 <= e.time_range.start < self.t1]

    def roofline(self, name: str,
                 bound_s: Callable[[object], Optional[float]]
                 ) -> Optional[float]:
        """Percent: the summed least time of the calls of operator
        ``name`` over the summed device time of their kernels; None where
        no call launched a kernel."""
        bound = spent = 0.0
        for event, us in self.op_calls(name):
            b = bound_s(event)
            if b is None or us <= 0:
                continue
            bound += b
            spent += us / 1e6
        return 100.0 * bound / spent if spent > 0 else None

    def top_device_ops(self, n: int = 10):
        by = collections.defaultdict(float)
        for start, end, name in self.device:
            by[name[:NAME_CHARS]] += (min(end, self.t1)
                                      - max(start, self.t0)) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the benchmark's span and the
        innermost operator open then."""
        span, op, op_start = "outside", "", None
        for e in self.host:
            r = e.time_range
            if not r.start <= t < r.end:
                continue
            if e.name in SPANS:
                span = e.name.split(".", 1)[1]
            elif e.name != WINDOW and (op_start is None or r.start > op_start):
                op, op_start = e.name, r.start
        return f"{span}:{op}" if op else span

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest idle gaps, [what the host was doing, seconds]."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._host_at(t), us / 1e6] for us, t in gaps[:n]]


def shapes(event) -> List:
    return list(getattr(event, "input_shapes", None) or [])


def scalar_input(event, index: int, default):
    """A scalar argument of ``event`` as the profiler recorded it, or
    ``default`` where it did not."""
    values = getattr(event, "concrete_inputs", None) or []
    if index < len(values) and values[index] not in (None, "", []):
        return values[index]
    return default
