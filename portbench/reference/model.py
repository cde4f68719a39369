"""What the benchmark's plain decoder LMs share, in float32.

Each model type (a configuration file's ``model_type``) has its module
beside this one, ``portbench/reference/<model_type>.py``, which gives its
parameter ``leaves(c)``, its ``active_params(c)`` and
``attention_dims(c)`` (and, where not every layer attends,
``attention_layers(c)`` and ``mixer_flops(c, seq, batch)``) for
:mod:`portbench.counts`, its ``Model``, a :class:`Decoder`, and ``TINY``,
the sizes its configurations take in the CPU tests.  :func:`family`
finds it by name, so a new model type is a new file.

The shared pieces: RMSNorm (eps from the file's ``reference`` block),
rotary embeddings in the rotate-half layout, causal softmax attention,
SwiGLU, pre-norm residual layers, an untied or tied head and the mean
token cross-entropy; and the Mamba-2 mixer (arXiv:2405.21060, the SSD
layer): :func:`causal_conv`, :func:`ssd`, :func:`gated_rmsnorm` and
:func:`mamba2_mixer` over the sizes of :class:`Mamba2Dims`.  What the
runs depart from in the published models is listed in each configuration
file under ``departures``.

Every matrix product goes through ``mm``, float32 by default;
:func:`fp8_mm` is the lower-precision control.  Each layer and the head
are recomputed in the backward pass (``torch.utils.checkpoint``), so the
reference fits beside its float32 state at the cells' sizes.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Mamba2Dims:
    """The sizes of a Mamba-2 mixer, which each model type maps from its
    own configuration keys."""
    heads: int          # H
    head_p: int         # P, the channels of a head
    state: int          # N
    groups: int         # G, B and C groups, each shared by H / G heads
    conv_width: int
    chunk: int          # positions of an SSD chunk

    @property
    def inner(self) -> int:
        return self.heads * self.head_p


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution with bias: x (B, S, C), w (W, C);
    ``out[t] = bias + sum_i w[i] * x[t - W + 1 + i]``, zeros before the
    first position."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return bias + sum(xp[:, i:i + s] * w[i] for i in range(width))


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, mm: MatMul = exact_mm) -> torch.Tensor:
    """The SSD recurrence ``h_t = e^{a_t} h_{t-1} + x_t b_t^T``,
    ``y_t = h_t c_t`` (h of a head (P, N), zero before the first
    position), in its chunked dual form: x (B, S, H, P), the log-decay
    a (B, S, H), b and c (B, S, G, N) with group g serving heads
    g*H/G .. (g+1)*H/G - 1 -> y (B, S, H, P).

    Chunk by chunk (the last may be shorter): within a chunk the
    quadratic form ``((C B^T) * L) X``, ``L[t, s] = e^{A_t - A_s}`` for
    s <= t and 0 above (A the chunk's running sum of a), plus the state
    carried in from the earlier chunks, ``e^{A_t} C h^T``; then the
    state passed on, ``e^{A_end} h + (X e^{A_end - A})^T B``.  The
    exponent of L is masked before ``exp``, so a steep decay gives no
    inf and its gradient no NaN.  Computed in x's type."""
    bsz, s, heads, head_p = x.shape
    groups, state_n = b.shape[2], b.shape[3]
    per = heads // groups
    h = x.new_zeros(bsz, groups, per, head_p, state_n)
    ys = []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        n = hi - lo
        xc = x[:, lo:hi].unflatten(2, (groups, per)).permute(0, 2, 3, 1, 4)
        cum = a[:, lo:hi].unflatten(2, (groups, per)).permute(
            0, 2, 3, 1).cumsum(-1)                         # (B,G,R,L)
        bc = b[:, lo:hi].transpose(1, 2)[:, :, None]       # (B,G,1,L,N)
        cc = c[:, lo:hi].transpose(1, 2)[:, :, None]
        above = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
        decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                          .masked_fill(above, -math.inf))  # (B,G,R,L,L)
        y = mm(mm(cc, bc.transpose(-1, -2)) * decay, xc)   # (B,G,R,L,P)
        wide = (bsz, groups, per, n, state_n)
        y = y + torch.exp(cum)[..., None] * mm(cc.expand(wide),
                                               h.transpose(-1, -2))
        tail = torch.exp(cum[..., -1:] - cum)[..., None]   # (B,G,R,L,1)
        h = (torch.exp(cum[..., -1])[..., None, None] * h
             + mm((xc * tail).transpose(-1, -2), bc.expand(wide)))
        ys.append(y)
    return torch.cat(ys, dim=3).permute(0, 3, 1, 2, 4).reshape(
        bsz, s, heads, head_p)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float, group_size: int) -> torch.Tensor:
    """``y * silu(z)`` RMS-normed over each group of ``group_size``
    channels of the last axis, times ``scale``."""
    g = y * F.silu(z)
    g = g.unflatten(-1, (g.shape[-1] // group_size, group_size))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return g.flatten(-2) * scale


def mamba2_mixer(p: Params, pre: str, x: torch.Tensor, dims: Mamba2Dims,
                 eps: float, mm: MatMul = exact_mm) -> torch.Tensor:
    """A Mamba-2 mixer of x (B, S, D) over the leaves under ``pre``, named
    as the port's parameter tree names them: ``in_proj.w`` (D, 2 inner +
    2 G N + H) to (z, x, B, C, dt); the causal convolution ``conv_w``
    (W, inner + 2 G N) with bias ``conv_b`` and silu over (x, B, C);
    ``dt = softplus(dt + dt_bias)``, ``A = -exp(a_log)``;
    ``y = SSD(x dt, A dt, B, C) + d_skip x``; the gated norm
    (``norm.scale``, a group of inner / G channels) and ``out_proj.w``."""
    bsz, s, _ = x.shape
    gn = dims.groups * dims.state
    z, xbc, dt = linear(x, p[pre + "in_proj.w"], mm).split(
        [dims.inner, dims.inner + 2 * gn, dims.heads], dim=-1)
    xbc = F.silu(causal_conv(xbc, p[pre + "conv_w"], p[pre + "conv_b"]))
    xs, bm, cm = xbc.split([dims.inner, gn, gn], dim=-1)
    dt = F.softplus(dt + p[pre + "dt_bias"])                 # (B,S,H)
    xh = xs.reshape(bsz, s, dims.heads, dims.head_p)
    y = ssd(xh * dt[..., None], -torch.exp(p[pre + "a_log"]) * dt,
            bm.reshape(bsz, s, dims.groups, dims.state),
            cm.reshape(bsz, s, dims.groups, dims.state), dims.chunk, mm)
    y = y + p[pre + "d_skip"][:, None] * xh
    y = gated_rmsnorm(y.reshape(bsz, s, dims.inner), z,
                      p[pre + "norm.scale"], eps, dims.inner // dims.groups)
    return linear(y, p[pre + "out_proj.w"], mm)


def family(c: Dict):
    """The module of configuration ``c``'s model type."""
    return importlib.import_module(f"portbench.reference.{c['model_type']}")


class Decoder:
    """A pre-norm decoder over a flat dict of per-layer float32
    parameters named as :func:`portbench.layout.per_layer_names` names
    them.  A model type gives ``layers`` ((name prefix, feed-forward
    kind) of each layer, and a third element, the name of the method
    that mixes the positions of a layer that does not attend),
    ``attention`` and ``feed_forward``."""

    def __init__(self, c: Dict, mm: MatMul = exact_mm):
        self.c, self.mm = c, mm
        self.eps = c["reference"]["norm_eps"]
        self.theta = float(c["rope_theta"])

    def layers(self) -> List[Tuple[str, ...]]:
        raise NotImplementedError

    def attention(self, p: Params, pre: str, x):
        raise NotImplementedError

    def feed_forward(self, p: Params, pre: str, x, kind: str):
        return swiglu(x, *(p[pre + f"mlp.{n}.w"]
                           for n in ("gate", "up", "down")), self.mm)

    def _layer(self, p: Params, pre: str, x, kind: str,
               mixer: str = "attention"):
        x = x + getattr(self, mixer)(p, pre, rmsnorm(x, p[pre + "ln1.scale"],
                                                     self.eps))
        return x + self.feed_forward(
            p, pre, rmsnorm(x, p[pre + "ln2.scale"], self.eps), kind)

    def loss(self, p: Params, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean token cross-entropy of ``tokens`` (B, S) against
        ``labels``."""
        x = p["embed.table"][tokens.long()]
        for pre, kind, *mixer in self.layers():
            x = checkpoint(self._layer, p, pre, x, kind, *mixer,
                           use_reentrant=False)
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
