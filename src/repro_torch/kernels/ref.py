"""Plain PyTorch versions of the ported kernels (the allclose reference).

Each hand-written Hopper kernel in this package has its plain version
here.  The wrappers take it for tensors that lie on the CPU, the CPU
tests hold the JAX package's oracles against it, and ``chip_smoke.py``
holds each kernel against it on the card.  The remaining oracles
(softmax, ssd) land with their kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NO_WINDOW = 1 << 30     # an attention window that masks nothing
NEG_LOGIT = -1e30       # the logit of a masked key


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, the precision of every plain version's math — or in f64
    when it is f64 already, so that an f64 model is an exact evaluation
    of the same function (the tests' yardstick for f32 rounding)."""
    return x if x.dtype == torch.float64 else x.float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` whose rows do not depend on how many rows there are.

    PyTorch's CPU GEMM takes another path for a one-row product than for
    two or more, and the two round differently (up to 2.5e-4 apart at
    2560x6912), while every product with two or more rows agrees bit for
    bit.  A decode lane must compute the same bits alone (``generate``
    at batch 1) as beside other lanes (the engine's fixed-width pass), so
    on the CPU a one-row product is padded to two rows."""
    if x.device.type == "cpu" and x.ndim >= 2 and x.numel() == x.shape[-1]:
        lead = x.shape[:-1]
        x2 = x.reshape(1, x.shape[-1])
        y = (torch.cat([x2, x2]) @ w)[:1]
        return y.reshape(*lead, w.shape[-1])
    return x @ w


def matmul_leakyrelu(a: torch.Tensor, b: torch.Tensor,
                     negative_slope: float = 0.01) -> torch.Tensor:
    """Fused GEMM + LeakyReLU epilogue: the product in f32, the epilogue
    on the f32 sum, one rounding to a's type (paper Table 2:
    mmLeakyReLu)."""
    af = wide(a)
    y = matmul(af, b.to(af.dtype))
    return torch.where(y >= 0, y, negative_slope * y).to(a.dtype)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch matrix multiplication (B, M, K) x (B, K, N) in f32, one
    rounding to a's type (paper Table 2: bmm)."""
    af = wide(a)
    return torch.matmul(af, b.to(af.dtype)).to(a.dtype)


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor) -> torch.Tensor:
    """Fused LLaMA-style feed-forward front half: silu(x@Wg) * (x@Wu),
    in f32, cast to x's type (paper Table 2: fused_ff)."""
    xf = wide(x)
    g = matmul(xf, w_gate.to(xf.dtype))
    u = matmul(xf, w_up.to(xf.dtype))
    return (F.silu(g) * u).to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square layer normalization over the last axis, in f32,
    cast to x's type (paper Table 2: rmsnorm)."""
    xf = wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(xf.dtype)).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = NO_WINDOW,
                    q_offset: int = 0,
                    scale: float = None) -> torch.Tensor:
    """Attention over the whole key axis in f32, cast to q's type (paper
    Table 2: flash-attention; the math of the reference's
    ``nn.attention.chunked_attention``).

    q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0 (query head h
    reads KV head h // (H // KH)).  Query row i sits at position
    ``q_offset + i`` and may see key j when ``j > q_pos - window`` and,
    if causal, ``j <= q_pos``; a masked logit is -1e30, and the row sum l
    is floored at 1e-30.  q is scaled before the product.  A row that sees
    no key gets the mean of v, as the reference's recurrence gives it."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    qf = wide(q).reshape(B, KH, G * Sq, D) * scale
    logits = torch.matmul(qf, k.to(qf.dtype).transpose(-1, -2))
    logits = logits.reshape(B, KH, G, Sq, Sk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos > q_pos - window
    if causal:
        mask = mask & (k_pos <= q_pos)
    logits = logits.masked_fill(~mask, NEG_LOGIT)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    ell = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.reshape(B, KH, G * Sq, Sk), v.to(qf.dtype))
    o = o.reshape(B, KH, G, Sq, Dv) / ell.clamp_min(1e-30)
    return o.reshape(B, H, Sq, Dv).to(q.dtype)
