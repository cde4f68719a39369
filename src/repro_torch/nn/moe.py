"""Mixture-of-Experts: top-k routing with two execution paths.

Port of ``repro/nn/moe.py``:

* ``dense`` — every expert computed on every token, outputs combined by
  the gates: the mesh-less layer and the oracle of the expert-parallel
  path.  So a mesh-less MoE layer's work is ``n_experts`` experts'
  products over every token, not ``top_k``'s.
* ``ep`` — expert parallelism over the ``model`` axis of a
  :class:`repro_torch.launch.mesh.Mesh`, run by every rank: each rank
  routes its sequence block of the tokens, packs them into
  fixed-capacity per-expert buffers (:func:`_pack_dispatch`; overflow
  drops, Switch/GShard semantics), exchanges the buffers by
  ``all_to_all`` so that each rank runs its own experts, and combines
  the results sent back.  Capacity counts the rank's own tokens, so the
  function depends on the mesh; with a generous capacity factor it
  equals the dense layer.  :func:`apply_moe_ep_replicated` is the
  variant for sequences the axis does not divide: local experts on every
  token, then a ``psum``.  :func:`apply_moe_ep_plain` computes the
  ``ep`` function in one process, block by block (tests and
  ``chip_smoke.py`` hold the distributed one against it).

The router's f32 product and the experts' three products are PyTorch
products, as the reference computes them outside any Pallas kernel; the
shared experts go through :func:`repro_torch.nn.layers.apply_swiglu`
(``ops.fused_ff``, K2 on the card), as the dense MLP does.

Under a profiler the router opens the span ``repro_torch.moe.router``
and each layer ``repro_torch.moe.experts`` (the shared experts' own
``repro_torch.mlp`` nested in it), and each layer's forward counts
``moe.pairs_routed`` (the (token, expert) pairs the router chose) and
``moe.pairs_computed`` (the pairs the experts ran):
:mod:`repro_torch.utils.spans`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.kernels.ref import matmul, wide
from repro_torch.nn.core import ParamSpec
from repro_torch.nn.layers import apply_swiglu
from repro_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    n_shared: int = 0          # always-on shared experts (DeepSeek style)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25


def moe_spec(cfg: MoEConfig) -> Dict:
    spec = {
        "router": {"w": ParamSpec((cfg.d_model, cfg.n_experts),
                                  ("embed", None))},
        "experts": {
            "gate": ParamSpec((cfg.n_experts, cfg.d_model, cfg.d_ff),
                              ("experts", "embed", "mlp")),
            "up": ParamSpec((cfg.n_experts, cfg.d_model, cfg.d_ff),
                            ("experts", "embed", "mlp")),
            "down": ParamSpec((cfg.n_experts, cfg.d_ff, cfg.d_model),
                              ("experts", "mlp", "embed")),
        },
    }
    if cfg.n_shared:
        d_sh = cfg.shared_d_ff or cfg.n_shared * cfg.d_ff
        spec["shared"] = {
            "gate": {"w": ParamSpec((cfg.d_model, d_sh), ("embed", "mlp"))},
            "up": {"w": ParamSpec((cfg.d_model, d_sh), ("embed", "mlp"))},
            "down": {"w": ParamSpec((d_sh, cfg.d_model), ("mlp", "embed"))},
        }
    return spec


def router_probs(p: Dict, x: torch.Tensor, cfg: MoEConfig):
    """(gate values (..., k), gate indices (..., k), probabilities (...,
    E)): the softmax of the f32 router logits and its top k, largest
    first."""
    with spans.span(spans.MOE_ROUTER):
        xf = wide(x)
        lead = x.shape[:-1]
        logits = matmul(xf.reshape(-1, x.shape[-1]),
                        p["router"]["w"].to(xf.dtype)).reshape(*lead, -1)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
        return gate_vals, gate_idx, probs


def _count_pairs(tokens: int, computed: int, cfg: MoEConfig) -> None:
    spans.count("moe.pairs_routed", tokens * cfg.top_k)
    spans.count("moe.pairs_computed", computed)


def _expert_ffn(experts: Dict, xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = matmul(xb, experts["gate"].to(xb.dtype))
    u = matmul(xb, experts["up"].to(xb.dtype))
    return matmul(F.silu(g) * u, experts["down"].to(xb.dtype))


def apply_moe_dense(p: Dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Oracle path: all experts on all tokens, gate-combined.

    Every expert runs on every token (``(E, T, d)`` outputs, the tokens
    broadcast to the experts as a view), and token t's output is the f32
    sum of its top-k experts' outputs weighted by their gates: the
    reference's sum over all experts with the one-hot gate weights, whose
    other terms are exact zeros."""
    B, S, D = x.shape
    T, E = B * S, cfg.n_experts
    _count_pairs(T, T * E, cfg)
    with spans.span(spans.MOE_EXPERTS):
        gate_vals, gate_idx, _ = router_probs(p, x, cfg)
        xt = x.reshape(T, D)
        y_all = _expert_ffn(p["experts"], xt.expand(E, T, D))  # (E, T, d)
        tok = torch.arange(T, device=x.device)
        picked = y_all[gate_idx.reshape(T, cfg.top_k).T, tok]  # (k, T, d)
        gates = gate_vals.reshape(T, cfg.top_k).T[..., None]   # (k, T, 1)
        y = (gates * picked.to(gates.dtype)).sum(dim=0)
        out = y.reshape(B, S, D).to(x.dtype)
        if cfg.n_shared:
            out = out + apply_swiglu(p["shared"], x)
        return out


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    arithmetic, exactly)."""
    return max(int(tokens * cfg.top_k * cfg.capacity_factor
                   // cfg.n_experts), 4)


def _pack_dispatch(xt, gate_vals, gate_idx, n_experts: int, cap: int):
    """Sort-free capacity dispatch: rank each (token, choice) slot within
    its expert by a cumulative count, drop beyond capacity, scatter into
    (E, C, d).  Returns the buffer, each slot's place in it (dropped
    slots: the extra row ``E * C``), its token, and its gate (0 where
    dropped)."""
    T, D = xt.shape
    k = gate_idx.shape[-1]
    flat_e = gate_idx.reshape(T * k)                    # expert of each slot
    flat_g = wide(gate_vals.reshape(T * k))
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(k)
    onehot = F.one_hot(flat_e, n_experts)               # (T*k, E)
    rank = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    buf = xt.new_zeros((n_experts * cap + 1, D)).index_put(
        (slot,), xt[flat_t])                            # drops land in slot -1
    return (buf[:-1].reshape(n_experts, cap, D), slot, flat_t,
            flat_g * keep.to(flat_g.dtype))


def dispatch(p: Dict, xs: torch.Tensor, cfg: MoEConfig):
    """Route a block of tokens (B, S, d) and pack it: the buffer (E, C,
    d), slots, tokens and gates of :func:`_pack_dispatch`, with C from
    the block's own token count."""
    B, S, D = xs.shape
    xt = xs.reshape(B * S, D)
    gate_vals, gate_idx, _ = router_probs(p, xt, cfg)
    return _pack_dispatch(xt, gate_vals, gate_idx, cfg.n_experts,
                          capacity(cfg, B * S))


def _combine(y: torch.Tensor, slot, flat_g, like: torch.Tensor):
    """Token t's output: the f32 sum of its k slots' expert outputs ``y``
    ((E * C, d), a dropped slot reading the zero row) weighted by their
    gates, in ``like``'s shape and type."""
    B, S, D = like.shape
    y = torch.cat([y, y.new_zeros((1, D))], dim=0)
    contrib = wide(y[slot]) * flat_g[:, None]           # (T*k, d)
    out = contrib.reshape(B * S, -1, D).sum(dim=1)
    return out.reshape(B, S, D).to(like.dtype)


def _ep_block(p: Dict, xs: torch.Tensor, cfg: MoEConfig, axis) -> torch.Tensor:
    """The reference's ``shard_map`` body of ``apply_moe_ep`` on this
    rank's token block ``xs``: route, pack, ``all_to_all`` the buffers so
    each rank holds every peer's rows for its local experts, run them,
    ``all_to_all`` back, combine."""
    ep, D = axis.size, xs.shape[-1]
    e_local = cfg.n_experts // ep
    buf, slot, _, flat_g = dispatch(p, xs, cfg)
    cap = buf.shape[1]
    _count_pairs(xs.shape[0] * xs.shape[1], cfg.n_experts * cap, cfg)
    # dim 0 of the exchanged buffer indexes the SOURCE rank: put it next
    # to capacity before flattening per local expert
    buf = col.all_to_all(buf.reshape(ep, e_local, cap, D), axis, 0, 0)
    buf = buf.transpose(0, 1).reshape(e_local, ep * cap, D)
    y = _expert_ffn(p["experts"], buf)                  # local experts
    y = y.reshape(e_local, ep, cap, D).transpose(0, 1)
    y = col.all_to_all(y.contiguous(), axis, 0, 0)      # (home, e_local, C, d)
    return _combine(y.reshape(cfg.n_experts * cap, D), slot, flat_g, xs)


def apply_moe_ep(p: Dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                 axis: str = "model", seq_sharded: bool = False
                 ) -> torch.Tensor:
    """Expert parallelism over ``axis``, run by every rank: ``x`` is this
    rank's batch block (B, S, d), the same on every rank of ``axis``,
    whose sequence block (the reference's ``P(dp, axis, None)``) the rank
    routes; ``p["experts"]`` holds its ``n_experts / axis size`` experts.
    The output is gathered back over the sequence.  ``seq_sharded``: ``x``
    is already the rank's sequence block (the sequence-parallel residual
    stream), and so is the output."""
    ax = mesh.axis(axis)
    assert cfg.n_experts % ax.size == 0, (cfg.n_experts, ax.size)
    with spans.span(spans.MOE_EXPERTS):
        xs = x if seq_sharded else col.block_of(x, ax, 1)
        out = _ep_block(p, xs, cfg, ax)
        if not seq_sharded:
            out = col.all_gather(out, ax, 1, tiled=True)
        if cfg.n_shared:
            out = out + apply_swiglu(p["shared"], x)
        return out


def apply_moe_ep_replicated(p: Dict, x: torch.Tensor, cfg: MoEConfig, mesh,
                            axis: str = "model") -> torch.Tensor:
    """EP for token counts too small to shard on ``axis``: every rank
    computes its local experts on all of its tokens ``x`` (the same on
    every rank of ``axis``) and the gate-weighted sum is a ``psum``.  Its
    counters count the layer's whole work, which each rank shares."""
    ax = mesh.axis(axis)
    B, S, D = x.shape
    T = B * S
    e_local = cfg.n_experts // ax.size
    _count_pairs(T, T * cfg.n_experts, cfg)
    with spans.span(spans.MOE_EXPERTS):
        xt = x.reshape(T, D)
        gate_vals, gate_idx, _ = router_probs(p, xt, cfg)
        onehot = F.one_hot(gate_idx, cfg.n_experts).to(gate_vals.dtype)
        weights = (gate_vals[..., None] * onehot).sum(dim=1)   # (T, E)
        lo = ax.index * e_local
        w_local = weights[:, lo:lo + e_local]               # (T, e_local)
        y_local = _expert_ffn(p["experts"], xt.expand(e_local, T, D))
        y = (w_local.T[..., None] * wide(y_local)).sum(dim=0)
        out = col.psum(y, ax).reshape(B, S, D).to(x.dtype)
        if cfg.n_shared:
            out = out + apply_swiglu(p["shared"], x)
        return out


def apply_moe_ep_plain(p: Dict, x: torch.Tensor, cfg: MoEConfig, dp: int,
                       ep: int):
    """The ``ep`` function of a (dp, ep) mesh in one process: the global
    tokens ``x`` (B, S, d) cut into the mesh's (batch, sequence) blocks,
    each routed and packed with its own capacity, every kept slot through
    its expert (an expert's row depends on that row alone, so no exchange
    is needed), and combined.  Returns (output, the slots of each block,
    in (dp, ep) order).  For tests and ``chip_smoke.py``."""
    B, S, D = x.shape
    bb, sb = B // dp, S // ep
    rows, slots = [], []
    for i in range(dp):
        cols = []
        for j in range(ep):
            xs = x[i * bb:(i + 1) * bb, j * sb:(j + 1) * sb]
            buf, slot, _, flat_g = dispatch(p, xs, cfg)
            y = _expert_ffn(p["experts"], buf).reshape(-1, D)
            cols.append(_combine(y, slot, flat_g, xs))
            slots.append(slot)
        rows.append(torch.cat(cols, dim=1))
    out = torch.cat(rows, dim=0)
    if cfg.n_shared:
        out = out + apply_swiglu(p["shared"], x)
    return out, slots


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig,
              mesh=None, axis: str = "model",
              seq_sharded: bool = False) -> torch.Tensor:
    """The reference's choice: with ``axis`` on ``mesh`` (> 1) dividing
    the expert count, expert parallelism — :func:`apply_moe_ep` when the
    sequence divides over the axis, else
    :func:`apply_moe_ep_replicated`; otherwise the dense layer, which is
    token by token and so also takes a sequence block
    (``seq_sharded``)."""
    if mesh is not None and mesh.shape.get(axis, 1) > 1 \
            and cfg.n_experts % mesh.shape[axis] == 0:
        if seq_sharded or x.shape[1] % mesh.shape[axis] == 0:
            return apply_moe_ep(p, x, cfg, mesh, axis, seq_sharded)
        return apply_moe_ep_replicated(p, x, cfg, mesh, axis)
    return apply_moe_dense(p, x, cfg)
