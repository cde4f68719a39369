"""What the benchmark's plain decoder LMs share, in float32.

Each model type (a configuration file's ``model_type``) has its module
beside this one, ``portbench/reference/<model_type>.py``, which gives its
parameter ``leaves(c)``, its ``active_params(c)`` and
``attention_dims(c)`` for :mod:`portbench.counts`, and its ``Model``, a
:class:`Decoder`.  :func:`family` finds it by name, so a new model type
is a new file.

The shared pieces: RMSNorm (eps from the file's ``reference`` block),
rotary embeddings in the rotate-half layout, causal softmax attention,
SwiGLU, pre-norm residual layers, an untied or tied head and the mean
token cross-entropy.  What the runs depart from in the published models
is listed in each configuration file under ``departures``.

Every matrix product goes through ``mm``, float32 by default;
:func:`fp8_mm` is the lower-precision control.  Each layer and the head
are recomputed in the backward pass (``torch.utils.checkpoint``), so the
reference fits beside its float32 state at the cells' sizes.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

HEAD_ROWS = 2048     # rows of the head and loss computed at a time


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448, the format's largest), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """A product of float8 operands accumulated in float32, forward and
    backward (the incoming gradient rounded to float8 too)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = _fp8(grad)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands in float8 (e4m3), one step
    below the bfloat16 the configurations train in."""
    return _Fp8MatMul.apply(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, ..., D) at positions 0..S-1: the
    first and second halves of the last axis are the pairs' two parts."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    ang = ang.view((1, s) + (1,) * (x.ndim - 3) + (half,))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, scale: float, mm: MatMul) -> torch.Tensor:
    """Causal softmax attention.  q (B, S, H, Dq), k (B, S, KH, Dq),
    v (B, S, KH, Dv) -> (B, S, H, Dv)."""
    h, kh = q.shape[2], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, .)
    s = q.shape[2]
    scores = mm(q * scale, k.transpose(-1, -2))
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, -math.inf), dim=-1)
    return mm(probs, v).transpose(1, 2)


def linear(x: torch.Tensor, w: torch.Tensor, mm: MatMul) -> torch.Tensor:
    lead = x.shape[:-1]
    return mm(x.reshape(-1, x.shape[-1]), w).view(*lead, w.shape[-1])


def swiglu(x, gate, up, down, mm: MatMul) -> torch.Tensor:
    return linear(F.silu(linear(x, gate, mm)) * linear(x, up, mm), down, mm)


def family(c: Dict):
    """The module of configuration ``c``'s model type."""
    return importlib.import_module(f"portbench.reference.{c['model_type']}")


class Decoder:
    """A pre-norm decoder over a flat dict of per-layer float32
    parameters named as :func:`portbench.layout.per_layer_names` names
    them.  A model type gives ``layers`` ((name prefix, feed-forward
    kind) of each layer), ``attention`` and ``feed_forward``."""

    def __init__(self, c: Dict, mm: MatMul = exact_mm):
        self.c, self.mm = c, mm
        self.eps = c["reference"]["norm_eps"]
        self.theta = float(c["rope_theta"])

    def layers(self) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def attention(self, p: Params, pre: str, x):
        raise NotImplementedError

    def feed_forward(self, p: Params, pre: str, x, kind: str):
        return swiglu(x, *(p[pre + f"mlp.{n}.w"]
                           for n in ("gate", "up", "down")), self.mm)

    def _layer(self, p: Params, pre: str, x, kind: str):
        x = x + self.attention(p, pre, rmsnorm(x, p[pre + "ln1.scale"],
                                               self.eps))
        return x + self.feed_forward(
            p, pre, rmsnorm(x, p[pre + "ln2.scale"], self.eps), kind)

    def loss(self, p: Params, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean token cross-entropy of ``tokens`` (B, S) against
        ``labels``."""
        x = p["embed.table"][tokens.long()]
        for pre, kind in self.layers():
            x = checkpoint(self._layer, p, pre, x, kind, use_reentrant=False)
        head = (p["embed.table"].t()
                if self.c.get("tie_word_embeddings", False)
                else p["lm_head.out.w"])
        x = x.reshape(-1, x.shape[-1])
        y = labels.reshape(-1).long()
        total = x.new_zeros(())
        for lo in range(0, x.shape[0], HEAD_ROWS):
            total = total + checkpoint(self._head_loss, p,
                                       x[lo:lo + HEAD_ROWS], head,
                                       y[lo:lo + HEAD_ROWS],
                                       use_reentrant=False)
        return total / x.shape[0]

    def _head_loss(self, p: Params, x, head, y):
        logits = self.mm(rmsnorm(x, p["final_norm.scale"], self.eps), head)
        return F.cross_entropy(logits, y, reduction="sum")


def build(c: Dict, mm: MatMul = exact_mm) -> Decoder:
    return family(c).Model(c, mm)
