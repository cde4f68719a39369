"""Norms, MLPs, embeddings — the dense substrate shared by all archs.

RMSNorm and the SwiGLU front half go through :mod:`repro_torch.kernels.ops`,
so on the card they run the hand-written kernels (``rmsnorm``,
``fused_ff``) and on the CPU their plain versions.  Layernorm, the gelu
MLP, the embedding and the unembedding stay plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import psum, psum_scatter
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul, wide
from repro_torch.nn.core import ParamSpec, apply_dense, dense
from repro_torch.utils import spans


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int, name_axis: str = "embed") -> Dict:
    return {"scale": ParamSpec((d,), (name_axis,), "ones")}


def apply_rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math, eps 1e-6, output in x's type — one ``ops.rmsnorm`` over
    the rows of x flattened to (rows, last axis)."""
    d = x.shape[-1]
    with spans.span(spans.NORM):
        y = ops.rmsnorm(x.reshape(-1, d).contiguous(),
                        p["scale"].to(x.dtype), eps=eps)
        return y.reshape(x.shape)


def layernorm_spec(d: int) -> Dict:
    return {"scale": ParamSpec((d,), ("embed",), "ones"),
            "bias": ParamSpec((d,), ("embed",), "zeros")}


def apply_layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    with spans.span(spans.NORM):
        xf = wide(x)
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].to(y.dtype)
                + p["bias"].to(y.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_spec(d_model: int, d_ff: int) -> Dict:
    return {
        "gate": dense(d_model, d_ff, ("embed", "mlp")),
        "up": dense(d_model, d_ff, ("embed", "mlp")),
        "down": dense(d_ff, d_model, ("mlp", "embed")),
    }


def tp_reduce(y: torch.Tensor, tp_axis, sp: bool = False) -> torch.Tensor:
    """Assemble a row-parallel product's partial sums ``y`` (B, S, d)
    over ``tp_axis``: a ``psum``, or under sequence parallelism
    (``sp``) a ``psum_scatter`` that leaves this rank its sequence block
    (Megatron-SP)."""
    return psum_scatter(y, tp_axis, 1) if sp else psum(y, tp_axis)


def apply_swiglu(p: Dict, x: torch.Tensor, tp_axis=None,
                 sp: bool = False) -> torch.Tensor:
    """silu(x·Wg) ⊙ (x·Wu) in one ``ops.fused_ff``, then the down
    projection.

    ``tp_axis`` (a bound :class:`repro_torch.dist.collectives.Axis`)
    enables explicit tensor parallelism: gate/up hold a ``d_ff / TP``
    column shard (the fused front half runs on it as it is), down holds
    the matching row shard, and the down product's partial sum is
    assembled by a ``psum``, whose backward is a ``psum`` of the
    cotangent — the reference's Megatron column→row pattern
    (:func:`tp_reduce`; ``sp``: reduce-scattered over the sequence)."""
    d = x.shape[-1]
    with spans.span(spans.MLP):
        h = ops.fused_ff(x.reshape(-1, d).contiguous(),
                         p["gate"]["w"].to(x.dtype), p["up"]["w"].to(x.dtype))
        if tp_axis is None:
            return apply_dense(p["down"], h).reshape(*x.shape[:-1], -1)
        y = matmul(h, p["down"]["w"].to(h.dtype))
        return tp_reduce(y.reshape(*x.shape[:-1], -1), tp_axis, sp)


def gelu_mlp_spec(d_model: int, d_ff: int, bias: bool = True) -> Dict:
    return {
        "up": dense(d_model, d_ff, ("embed", "mlp"), bias=bias),
        "down": dense(d_ff, d_model, ("mlp", "embed"), bias=bias),
    }


def apply_gelu_mlp(p: Dict, x: torch.Tensor, tp_axis=None,
                   sp: bool = False) -> torch.Tensor:
    with spans.span(spans.MLP):
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(apply_dense(p["up"], x), approximate="tanh")
        if tp_axis is None:
            return apply_dense(p["down"], h)
        # the down bias is replicated over the TP axis: add it once, after
        # the partial-sum psum (folding it into apply_dense would count it
        # TP times)
        y = tp_reduce(matmul(h, p["down"]["w"].to(h.dtype)), tp_axis, sp)
        if "w_b" in p["down"]:
            y = y + p["down"]["w_b"].to(y.dtype)
        return y


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_spec(vocab: int, d_model: int) -> Dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"),
                               "embed", scale=1.0)}


def apply_embedding(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in f32 for a stable softmax/loss."""
    xf = wide(x)
    return matmul(xf, p["table"].to(xf.dtype).T)


def lm_head_spec(d_model: int, vocab: int) -> Dict:
    return {"out": dense(d_model, vocab, ("embed", "vocab"))}


def apply_lm_head(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return apply_dense(p["out"], wide(x))
