"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060).

Port of ``repro/nn/ssm.py``.  The full-sequence path (training, prefill)
calls the SSD scan through :func:`repro_torch.kernels.ops.ssd_chunk`, so
on the card it runs the hand-written kernel (``csrc/ssd.cu``) and on the
CPU its plain version; decode carries an O(1) recurrent state
(B, H, P, N) plus a depthwise-conv tail.  Math runs in f32 where the
reference asks for it, and in f64 for an f64 model (the tests' exact
evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.kernels import ops
from repro_torch.kernels.ref import wide
from repro_torch.nn.core import ParamSpec, apply_dense, dense
from repro_torch.nn.layers import apply_rmsnorm, rmsnorm_spec

CONV_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int            # usually 2 * d_model
    n_heads: int            # d_inner // head_p
    head_p: int             # channels per head (P)
    n_groups: int           # B/C groups (G)
    d_state: int            # N


def ssm_spec(cfg: SSMConfig) -> Dict:
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    return {
        "in_proj": dense(cfg.d_model, d_in_proj, ("embed", "mlp")),
        "conv_w": ParamSpec((CONV_WIDTH, conv_dim), (None, "mlp"), "normal",
                            scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), "zeros"),
        "a_log": ParamSpec((cfg.n_heads,), ("heads",), "zeros"),
        "d_skip": ParamSpec((cfg.n_heads,), ("heads",), "ones"),
        "dt_bias": ParamSpec((cfg.n_heads,), ("heads",), "zeros"),
        "norm": rmsnorm_spec(cfg.d_inner, "mlp"),
        "out_proj": dense(cfg.d_inner, cfg.d_model, ("mlp", "embed")),
    }


def _split_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    """(z, x, b, c, dt) views of the input projection's last axis."""
    gn = cfg.n_groups * cfg.d_state
    return torch.split(zxbcdt, [cfg.d_inner, cfg.d_inner, gn, gn,
                                cfg.n_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_WIDTH.  x: (B, S, C); w: (W, C)."""
    pads = F.pad(x, (0, 0, CONV_WIDTH - 1, 0))
    out = sum(pads[:, i: i + x.shape[1], :] * w[i][None, None, :]
              for i in range(CONV_WIDTH))
    return out + b[None, None, :]


def _decay(p: Dict, dt: torch.Tensor):
    """(dt, a): the softplus step and the log-decay -exp(a_log) * dt, in
    f32 (f64 for an f64 model)."""
    dt = wide(dt)
    dt = F.softplus(dt + p["dt_bias"].to(dt.dtype))
    return dt, -torch.exp(p["a_log"].to(dt.dtype)) * dt


def apply_ssm(p: Dict, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Training/prefill forward.  x: (B, S, d_model)."""
    B, S, _ = x.shape
    gn = cfg.n_groups * cfg.d_state
    z, xs, b, c, dt = _split_proj(cfg, apply_dense(p["in_proj"], x))
    conv_in = torch.cat([xs, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype)))
    xs, b, c = torch.split(conv_out, [cfg.d_inner, gn, gn], dim=-1)

    dt, a = _decay(p, dt)                                        # (B,S,H)
    xh = xs.reshape(B, S, cfg.n_heads, cfg.head_p)
    xh = xh * dt[..., None].to(xh.dtype)                         # dt-scaled
    bh = b.reshape(B, S, cfg.n_groups, cfg.d_state)
    ch = c.reshape(B, S, cfg.n_groups, cfg.d_state)
    y = ops.ssd_chunk(xh, a, bh, ch)                             # (B,S,H,P)
    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = apply_rmsnorm(p["norm"], y * F.silu(z))
    return apply_dense(p["out_proj"], y)


# ---------------------------------------------------------------------------
# decode: O(1) state per step
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> Dict:
    """Zeroed decode cache on ``device``: the conv tail in ``dtype`` (the
    model's), the recurrent state always in f32, as in the reference."""
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_p, cfg.d_state),
                             dtype=torch.float32, device=device),
    }


def apply_ssm_decode(p: Dict, x: torch.Tensor, cache: Dict,
                     cfg: SSMConfig, in_axis=None, channels_axis=None,
                     heads_axis=None,
                     out_axis=None) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, d_model).

    Under a mesh (bound axes, each where its block is this rank's):
    ``in_axis`` — ``in_proj`` holds a block of columns, whose products
    are all-gathered (z, x, B, C and dt do not align with its blocks);
    ``channels_axis`` — the conv weights and tail hold a block of
    channels, whose convolution is computed here and all-gathered;
    ``heads_axis`` — the state holds a block of heads, which this rank
    updates before ``y`` is all-gathered for the gated norm;
    ``out_axis`` — ``out_proj`` holds a block of rows, whose partial
    product is psummed."""
    B = x.shape[0]
    gn = cfg.n_groups * cfg.d_state
    proj = apply_dense(p["in_proj"], x)
    if in_axis is not None:
        proj = col.all_gather(proj, in_axis, 2, tiled=True)
    z, xs, b, c, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b, c], dim=-1)                      # (B,1,C)
    w, cb = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if channels_axis is not None:
        conv_in = col.block_of(conv_in, channels_axis, 2)
    window = torch.cat([cache["conv"], conv_in], dim=1)          # (B,W,C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, w)[:, None, :]
                      + cb[None, None, :])
    if channels_axis is not None:
        conv_out = col.all_gather(conv_out, channels_axis, 2, tiled=True)
    xs, b, c = torch.split(conv_out, [cfg.d_inner, gn, gn], dim=-1)

    dt, a = _decay(p, dt[:, 0])                                  # (B,H)
    xh = xs.reshape(B, cfg.n_heads, cfg.head_p) * dt[..., None].to(xs.dtype)
    rep = cfg.n_heads // cfg.n_groups
    bh = b.reshape(B, cfg.n_groups, cfg.d_state).repeat_interleave(rep, 1)
    ch = c.reshape(B, cfg.n_groups, cfg.d_state).repeat_interleave(rep, 1)
    d_skip = p["d_skip"].to(xh.dtype)
    if heads_axis is not None:
        xh, a, bh, ch = (col.block_of(t, heads_axis, 1)
                         for t in (xh, a, bh, ch))
        d_skip = col.block_of(d_skip, heads_axis, 0)

    decay = torch.exp(a)[..., None, None]                        # (B,H,1,1)
    state = cache["state"] * decay + (wide(xh)[..., None]
                                      * wide(bh)[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, wide(ch).to(state.dtype))
    y = y.to(x.dtype) + xh * d_skip[None, :, None]
    if heads_axis is not None:
        y = col.all_gather(y, heads_axis, 1, tiled=True)
    y = y.reshape(B, 1, cfg.d_inner)
    y = apply_rmsnorm(p["norm"], y * F.silu(z))
    if out_axis is not None:
        out = col.psum(apply_dense(p["out_proj"],
                                   col.block_of(y, out_axis, 2)), out_axis)
    else:
        out = apply_dense(p["out_proj"], y)
    return out, {"conv": window[:, 1:], "state": state}
