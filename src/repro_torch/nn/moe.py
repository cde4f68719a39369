"""Mixture-of-Experts: top-k routing, mesh-less.

Port of the mesh-less half of ``repro/nn/moe.py``: the ``dense`` path —
every expert computed on every token, outputs combined by the gates —
which the reference uses on one device and as the oracle of its
expert-parallel path.  So an MoE layer's work here is ``n_experts``
experts' products over every token, not ``top_k``'s.  The
expert-parallel paths (``apply_moe_ep``, ``apply_moe_ep_replicated``:
``shard_map`` + ``all_to_all`` over the ``model`` axis) belong to the
GSPMD path (ROADMAP A14b): with a mesh, :func:`apply_moe` raises.

The router's f32 product and the experts' three products are PyTorch
products, as the reference computes them outside any Pallas kernel; the
shared experts go through :func:`repro_torch.nn.layers.apply_swiglu`
(``ops.fused_ff``, K2 on the card), as the dense MLP does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import matmul, wide
from repro_torch.nn.core import ParamSpec
from repro_torch.nn.layers import apply_swiglu

_DIST_ITEM = "ROADMAP A14b (the GSPMD path)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    n_shared: int = 0          # always-on shared experts (DeepSeek style)
    shared_d_ff: int = 0


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
    xf = wide(x)
    lead = x.shape[:-1]
    logits = matmul(xf.reshape(-1, x.shape[-1]),
                    p["router"]["w"].to(xf.dtype)).reshape(*lead, -1)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return gate_vals, gate_idx, probs


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
    gate_vals, gate_idx, _ = router_probs(p, x, cfg)
    xt = x.reshape(T, D)
    y_all = _expert_ffn(p["experts"], xt.expand(E, T, D))      # (E, T, d)
    tok = torch.arange(T, device=x.device)
    picked = y_all[gate_idx.reshape(T, cfg.top_k).T, tok]      # (k, T, d)
    gates = gate_vals.reshape(T, cfg.top_k).T[..., None]       # (k, T, 1)
    y = (gates * picked.to(gates.dtype)).sum(dim=0)
    out = y.reshape(B, S, D).to(x.dtype)
    if cfg.n_shared:
        out = out + apply_swiglu(p["shared"], x)
    return out


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig,
              mesh=None, axis: str = "model") -> torch.Tensor:
    """The mesh-less layer (:func:`apply_moe_dense`); a mesh (the
    reference's expert-parallel dispatch) raises."""
    if mesh is not None:
        raise NotImplementedError(f"apply_moe: the expert-parallel paths "
                                  f"(mesh, axis {axis!r}) are not ported "
                                  f"yet; see {_DIST_ITEM}")
    return apply_moe_dense(p, x, cfg)
