"""Rotary position embeddings (shared by every attention family here)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import wide


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    xf = wide(x)
    freqs = rope_freqs(d, theta, device=x.device).to(xf.dtype)  # (d/2,)
    ang = positions[..., None].to(xf.dtype) * freqs            # (..., S, d/2)
    if x.ndim == ang.ndim + 1:                                 # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
