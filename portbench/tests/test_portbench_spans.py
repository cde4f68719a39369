"""The attribution of a traced run's device time to the port's spans
(``portbench/spans.py``) and the readers of the ten metrics built on it,
on synthetic profiles: host event trees whose events carry the kernels
they launched, and the device activities those kernels are."""

import importlib
import itertools
import types

import pytest
from torch.autograd import DeviceType

from portbench import spans
from portbench.trace import Trace

PARTITION = ["attn_ms", "mlp_ms", "norm_ms", "moe_router_ms",
             "moe_experts_ms", "vocab_ms", "optim_ms", "unspanned_ms"]
READERS = PARTITION + ["recompute_ms", "moe_useful_pct"]
IDS = itertools.count(1)


class Ev:
    """What ``portbench.trace`` and ``portbench.spans`` read of a
    ``torch.autograd.profiler_util.FunctionEvent``."""

    def __init__(self, name, start, end, *children, thread=1, seq=-1,
                 fwd_thread=0, kernels=(), device=DeviceType.CPU, id=None):
        self.name = name
        self.id = next(IDS) if id is None else id
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.thread, self.sequence_nr = thread, seq
        self.fwd_thread = fwd_thread
        self.kernels = [types.SimpleNamespace(name=n, duration=d)
                        for n, d in kernels]
        self.device_type = device
        self.is_user_annotation = name.startswith("repro_torch.")
        self.cpu_parent = None
        self.cpu_children = list(children)
        for c in children:
            c.cpu_parent = self


def flatten(*roots):
    out = []
    stack = list(roots)
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.cpu_children)
    return out


def op(name, start, end, us=0.0, **kw):
    """An operator that launched one kernel of ``us`` microseconds."""
    return Ev(name, start, end, kernels=[(f"k_{name}", us)] if us else (),
              **kw)


def trace_of(*roots, steps=((10, 100),), kernels=None):
    """A Trace of the window (0, 1e6) holding ``roots`` and the device
    activities ``kernels`` ((start, end) each; by default one back to
    back for each kernel the events launched)."""
    host = flatten(*roots)
    host.append(Ev("portbench.window", 0, 1e6))
    host += [Ev("portbench.step", a, b) for a, b in steps]
    if kernels is None:
        t, kernels = 0.0, []
        for e in host:
            for k in e.kernels:
                kernels.append((t, t + k.duration))
                t += k.duration
    device = [Ev("kernel", a, b, device=DeviceType.CUDA) for a, b in kernels]
    # a span's image on the device's timeline is no work
    device.append(Ev("repro_torch.attn", 0, 900, device=DeviceType.CUDA))
    return Trace(host + device)


def rec_of(trace):
    return types.SimpleNamespace(trace=trace)


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


def test_the_innermost_span_wins():
    t = trace_of(Ev(
        "repro_torch.attn", 20, 60,
        op("aten::mm", 21, 25, 3.0),
        Ev("repro_torch.norm", 30, 40, op("aten::mul", 31, 35, 5.0)),
        # the span's own device image, attached like a kernel, is no work
        kernels=[("repro_torch.attn", 40.0)]))
    s = spans.split(t)
    assert s.us == {"repro_torch.attn": 3.0, "repro_torch.norm": 5.0}
    assert s.seen == {"repro_torch.attn", "repro_torch.norm"}
    assert spans.split(t) is s          # computed once a trace


def test_a_kernel_attached_to_two_events_of_one_id_counts_once():
    mm = op("aten::mm", 21, 29, 6.0)
    # CUPTI's event for a launch that waited, with the operator's id and
    # so its kernels
    mm.cpu_children.append(Ev("Command Buffer Full", 22, 23, id=mm.id,
                              kernels=[("k_aten::mm", 6.0)]))
    mm.cpu_children[0].cpu_parent = mm
    s = spans.split(trace_of(Ev("repro_torch.mlp", 20, 30, mm),
                             kernels=[(21, 27)]))
    assert s.us == {"repro_torch.mlp": 6.0}


def test_backward_time_goes_to_the_forward_span():
    forward = [
        # two forward events with one (thread, sequence number): the
        # later made the node
        Ev("repro_torch.attn", 11, 15, op("aten::view", 12, 13, seq=7)),
        Ev("repro_torch.mlp", 16, 30, op("aten::mm", 17, 20, 2.0, seq=7)),
        op("aten::add", 31, 32, 1.0, seq=8),            # unspanned
    ]
    backward = [
        Ev(spans.EVALUATE + "MmBackward0", 40, 50,
           Ev("MmBackward0", 41, 49, op("aten::mm", 42, 45, 10.0, thread=2),
              thread=2, seq=7, fwd_thread=1),
           thread=2, seq=7, fwd_thread=1),
        Ev(spans.EVALUATE + "AddBackward0", 51, 55,
           op("aten::copy_", 52, 53, 4.0, thread=2),
           thread=2, seq=8, fwd_thread=1),
    ]
    s = spans.split(trace_of(*forward, *backward))
    assert s.us == {"repro_torch.mlp": 12.0, None: 5.0}
    assert s.by_node == {("MmBackward0", "repro_torch.mlp"): 10.0,
                         ("AddBackward0", None): 4.0}


def test_recompute_overlaps_the_layers():
    fwd = Ev("repro_torch.mlp", 11, 20, op("aten::mm", 12, 19, 8.0, seq=3))
    bwd = Ev(spans.EVALUATE + "MmBackward0", 30, 90,
             Ev(spans.RECOMPUTE, 31, 60,
                Ev("repro_torch.attn", 32, 40, op("aten::bmm", 33, 39, 4.0)),
                op("aten::add", 41, 42, 2.0, seq=-1),
                thread=2),
             op("aten::mm", 61, 80, 16.0, thread=2),
             thread=2, seq=3, fwd_thread=1)
    t = trace_of(fwd, bwd)
    s = spans.split(t)
    assert s.us == {"repro_torch.mlp": 24.0, "repro_torch.attn": 4.0,
                    None: 2.0}
    assert s.recompute_us == 6.0
    assert read("recompute_ms", rec_of(t)) == pytest.approx(6.0 / 1e3)


def _full_step(base: float, seq: int):
    """One step's events at ``base``: every partition span with a kernel
    of its own, a backward of each, work outside any span."""
    names = ["attn", "mlp", "norm", "moe.router", "moe.experts", "embed",
             "head", "loss", "optim"]
    fwd, bwd = [], []
    for i, n in enumerate(names):
        us = float(2 ** i)
        t = base + 2 * i
        fwd.append(Ev("repro_torch." + n, t, t + 1.5,
                      op("aten::op", t + 0.1, t + 1, us, seq=seq + i)))
        bwd.append(Ev(spans.EVALUATE + "Node", base + 40 + 2 * i,
                      base + 41 + 2 * i,
                      op("aten::grad", base + 40.1 + 2 * i,
                         base + 40.9 + 2 * i, 3 * us, thread=2),
                      thread=2, seq=seq + i, fwd_thread=1))
    rest = op("aten::add", base + 30, base + 31, 1000.0)
    return fwd + bwd + [rest]


def test_every_kernel_is_claimed_once_by_the_partition():
    events = _full_step(10, 0) + _full_step(110, 100)
    # a kernel launched outside the steps belongs to no step
    events.append(op("aten::fill_", 300, 301, 77.0))
    t = trace_of(*events, steps=((10, 100), (110, 200)))
    rec = rec_of(t)
    parts = {n: read(n, rec) for n in PARTITION}
    assert all(v is not None for v in parts.values()), parts
    assert parts["attn_ms"] == pytest.approx(2 * 4 * 1 / 1e3 / 2)
    assert parts["vocab_ms"] == pytest.approx((32 + 64 + 128) * 4 / 1e3)
    assert parts["unspanned_ms"] == pytest.approx(1000 * 2 / 1e3 / 2)
    launched = sum(k.duration for e in t.host for k in e.kernels
                   if not k.name.startswith("repro_torch."))
    assert sum(parts.values()) == pytest.approx((launched - 77.0) / 1e3 / 2)
    # back to back on the device: the partition is the busy time
    assert sum(parts.values()) == pytest.approx(
        (t.busy_s * 1e3 - 77.0 / 1e3) / 2)


def test_idle_gaps_go_to_the_span_the_host_was_in():
    events = [Ev("repro_torch.attn", 10, 50,
                 op("aten::mm", 11, 12, 5.0),
                 Ev("repro_torch.norm", 20, 30, op("aten::mul", 21, 22)))]
    t = trace_of(*events, kernels=[(11, 16), (25, 40), (45, 60)])
    idle = spans.idle_by_span(t)
    # the gap at 16-25 opens in attn, at 40-45 in attn again (norm shut)
    assert idle == {"repro_torch.attn": pytest.approx((9 + 5) / 1e6)}


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_a_trace(name):
    assert read(name, rec_of(None)) is None


@pytest.mark.parametrize("name", [n for n in READERS
                                  if n != "moe_useful_pct"])
def test_a_program_with_no_spans_reads_nothing(name):
    t = trace_of(op("aten::mm", 20, 30, 5.0, seq=1))
    assert read(name, rec_of(t)) is None
