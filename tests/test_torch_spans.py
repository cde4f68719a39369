"""The train step's profiler spans and MoE counters
(``repro_torch/utils/spans.py``), on the CPU at reduced widths in f32
with remat ``"nothing"``: a dense model (stablelm-3b) and one with MLA
and MoE (deepseek-v2-lite-16b).

Checked under ``torch.profiler``: every layer span opens, and
``repro_torch.recompute`` opens only inside the backward pass; every
backward node links to a forward operator by (``fwd_thread``,
``sequence_nr``), the latest of that key to start, and the layer spans'
own operators make nodes whose backward links back into them; the MoE
counters count tokens × top_k and tokens × experts a layer a step,
nothing during the recompute.  Without a profiler ``span`` is the shared
no-op, no ``record_function`` opens and no counter moves.  Profiling
changes no bit of the loss or of any gradient."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_data
from repro_torch.models import lm
from repro_torch.train import compute_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves

ARCHS = ["stablelm-3b", "deepseek-v2-lite-16b"]
SEQ, BATCH = 16, 2
LAYER_SPANS = {spans.ATTN, spans.NORM, spans.MLP, spans.EMBED, spans.HEAD,
               spans.LOSS, spans.OPTIM}
MOE_SPANS = {spans.MOE_ROUTER, spans.MOE_EXPERTS}
EVALUATE = "autograd::engine::evaluate_function"


def _cfg(arch):
    return get_config(arch, reduced=True).replace(remat=True,
                                                  remat_policy="nothing")


def _setup(arch):
    cfg = _cfg(arch)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             make_data(cfg, SEQ, BATCH, seed=3).batch_at(0).items()}
    return cfg, params, batch


def _step(cfg, params, batch):
    opt = optim.adamw(3e-3, weight_decay=0.1, max_grad_norm=1.0)
    state = TrainState({k: v for k, v in params.items()}, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    return make_train_step(cfg, opt)(state, batch)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _backward(e):
    return e.fwd_thread > 0 and e.sequence_nr >= 0


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def _span_of(e):
    """The innermost program span around ``e``, or None."""
    for a in _ancestors(e):
        if a.name.startswith("repro_torch."):
            return a.name
    return None


def _forward_ops(events):
    """(thread, sequence_nr) -> the forward operator of that key that
    started last, the one whose node the backward runs."""
    out = {}
    for e in events:
        if e.sequence_nr >= 0 and not _backward(e):
            key = (e.thread, e.sequence_nr)
            if key not in out or e.time_range.start >= \
                    out[key].time_range.start:
                out[key] = e
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_span_opens_and_recompute_only_in_backward(arch):
    cfg, params, batch = _setup(arch)
    _, events = _profiled(lambda: _step(cfg, params, batch))
    names = {e.name for e in events}
    want = LAYER_SPANS | {spans.RECOMPUTE}
    if cfg.family == "moe":
        want |= MOE_SPANS
    assert want <= names, sorted(want - names)
    recomputes = [e for e in events if e.name == spans.RECOMPUTE]
    assert len(recomputes) == cfg.n_layers
    for e in recomputes:
        assert any(a.name.startswith(EVALUATE) for a in _ancestors(e))
    # the layers open again inside the recompute, and outside it too
    inner = {e.name for e in events if e.name.startswith("repro_torch.")
             and any(a.name == spans.RECOMPUTE for a in _ancestors(e))}
    assert {spans.ATTN, spans.NORM, spans.MLP} <= inner
    outer = [e for e in events if e.name == spans.ATTN
             and not any(a.name.startswith(EVALUATE) for a in _ancestors(e))]
    assert len(outer) == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_nodes_map_to_their_forward_span(arch):
    cfg, params, batch = _setup(arch)
    _, events = _profiled(lambda: compute_grads(params, batch, cfg))
    fwd = _forward_ops(events)
    nodes = [e for e in events if _backward(e)
             and e.name.startswith(EVALUATE)]
    assert nodes
    reached = set()
    for e in nodes:
        op = fwd.get((e.fwd_thread, e.sequence_nr))
        assert op is not None, (e.name, e.fwd_thread, e.sequence_nr)
        assert op.time_range.start < e.time_range.start
        span = _span_of(op)
        if span is not None:
            reached.add(span)
    # each spanned forward operator that made a node is found again from
    # the node, in its own span
    made = {(e.fwd_thread, e.sequence_nr) for e in nodes}
    for key, op in fwd.items():
        span = _span_of(op)
        if span is not None and key in made:
            assert span in reached
    want = {spans.ATTN, spans.NORM, spans.MLP, spans.EMBED, spans.HEAD,
            spans.LOSS}
    if cfg.family == "moe":
        want |= MOE_SPANS
    assert want <= reached, sorted(want - reached)


@pytest.mark.parametrize("arch", ARCHS)
def test_untraced_opens_no_span_and_counts_nothing(arch, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened untraced")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span(spans.ATTN) is spans.span(spans.MLP)
    assert isinstance(spans.span(spans.ATTN), contextlib.nullcontext)
    assert isinstance(spans.recompute(), contextlib.nullcontext)
    cfg, params, batch = _setup(arch)
    spans.reset()
    _, metrics = _step(cfg, params, batch)
    assert torch.isfinite(metrics["loss"])
    spans.count("moe.pairs_routed", 5)
    assert spans.counters() == {}


def test_moe_counters_count_each_forward_once():
    cfg, params, batch = _setup("deepseek-v2-lite-16b")
    spans.reset()
    try:
        _, events = _profiled(lambda: _step(cfg, params, batch))
        counts = spans.counters()
    finally:
        spans.reset()
    assert any(e.name == spans.RECOMPUTE for e in events)
    layers = cfg.n_layers - cfg.first_dense_layers
    tokens = BATCH * SEQ
    assert counts == {"moe.pairs_routed": layers * tokens * cfg.top_k,
                      "moe.pairs_computed": layers * tokens * cfg.n_experts}


@pytest.mark.parametrize("arch", ARCHS)
def test_profiling_changes_no_bit(arch):
    cfg, params, batch = _setup(arch)
    loss, grads = compute_grads(params, batch, cfg)
    (ploss, pgrads), _ = _profiled(lambda: compute_grads(params, batch, cfg))
    spans.reset()
    assert torch.equal(loss, ploss)
    for g, pg in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert torch.equal(g, pg)
