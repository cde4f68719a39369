"""Plain PyTorch versions of the ported kernels (the allclose reference).

Each hand-written Hopper kernel in this package has its plain version
here.  The wrappers take it for tensors that lie on the CPU, the CPU
tests hold the JAX package's oracles against it, and ``chip_smoke.py``
holds each kernel against it on the card.  The remaining oracles
(matmul_leakyrelu, bmm, softmax, flash_attention, ssd) land with their
kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor) -> torch.Tensor:
    """Fused LLaMA-style feed-forward front half: silu(x@Wg) * (x@Wu),
    in f32, cast to x's type (paper Table 2: fused_ff)."""
    xf = x.float()
    g = matmul(xf, w_gate.float())
    u = matmul(xf, w_up.float())
    return (F.silu(g) * u).to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square layer normalization over the last axis, in f32,
    cast to x's type (paper Table 2: rmsnorm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)
