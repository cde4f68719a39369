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

from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul
from repro_torch.nn.core import ParamSpec, apply_dense, dense


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int, name_axis: str = "embed") -> Dict:
    return {"scale": ParamSpec((d,), (name_axis,), "ones")}


def apply_rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math, eps 1e-6, output in x's type — one ``ops.rmsnorm`` over
    the rows of x flattened to (rows, last axis)."""
    d = x.shape[-1]
    y = ops.rmsnorm(x.reshape(-1, d).contiguous(), p["scale"].to(x.dtype),
                    eps=eps)
    return y.reshape(x.shape)


def layernorm_spec(d: int) -> Dict:
    return {"scale": ParamSpec((d,), ("embed",), "ones"),
            "bias": ParamSpec((d,), ("embed",), "zeros")}


def apply_layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_spec(d_model: int, d_ff: int) -> Dict:
    return {
        "gate": dense(d_model, d_ff, ("embed", "mlp")),
        "up": dense(d_model, d_ff, ("embed", "mlp")),
        "down": dense(d_ff, d_model, ("mlp", "embed")),
    }


def apply_swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x·Wg) ⊙ (x·Wu) in one ``ops.fused_ff``, then the down
    projection.  (The reference's ``tp_axis`` tensor-parallel variant
    waits for the port's distribution slice.)"""
    d = x.shape[-1]
    h = ops.fused_ff(x.reshape(-1, d).contiguous(),
                     p["gate"]["w"].to(x.dtype), p["up"]["w"].to(x.dtype))
    return apply_dense(p["down"], h).reshape(*x.shape[:-1], -1)


def gelu_mlp_spec(d_model: int, d_ff: int, bias: bool = True) -> Dict:
    return {
        "up": dense(d_model, d_ff, ("embed", "mlp"), bias=bias),
        "down": dense(d_ff, d_model, ("mlp", "embed"), bias=bias),
    }


def apply_gelu_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(apply_dense(p["up"], x), approximate="tanh")
    return apply_dense(p["down"], h)


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
    return matmul(x.float(), p["table"].float().T)


def lm_head_spec(d_model: int, vocab: int) -> Dict:
    return {"out": dense(d_model, vocab, ("embed", "vocab"))}


def apply_lm_head(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return apply_dense(p["out"], x.float())
