"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``repro/nn/mla.py``.  KV is compressed to a ``kv_lora_rank``-dim
latent plus a shared RoPE key part; the decode cache stores only the
latent (and the rope key), the MLA memory win.  Training materializes
full K/V and goes through ``chunked_attention`` (K6 on the card, at head
dims 192 for q and k and 128 for v); decode uses the weight-absorbed
latent-space form in plain PyTorch, as the reference's jnp.  ``kv_norm``
is ``apply_rmsnorm`` (K1 on the card).

The absorbed decode products are laid out so that a lane's result does
not depend on how many lanes there are (per (lane, head) rows, or the
heads of one lane as rows), so a request decodes the same bits alone
(``generate``) as in the engine's fixed-width pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG_LOGIT, matmul, wide
from repro_torch.nn.attention import (chunked_attention, decode_positions,
                                      gather_pages, paged_update_cache,
                                      split_softmax, update_cache_block)
from repro_torch.nn.core import ParamSpec, apply_dense, dense
from repro_torch.nn.layers import apply_rmsnorm, rmsnorm_spec
from repro_torch.nn.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_spec(cfg: MLAConfig) -> Dict:
    H = cfg.n_heads
    return {
        "wq": dense(cfg.d_model, H * cfg.qk_dim, ("embed", "heads")),
        "w_dkv": dense(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim,
                       ("embed", None)),
        "kv_norm": rmsnorm_spec(cfg.kv_lora_rank, None),
        "w_uk": ParamSpec((cfg.kv_lora_rank, H, cfg.qk_nope_dim),
                          (None, "heads", None)),
        "w_uv": ParamSpec((cfg.kv_lora_rank, H, cfg.v_head_dim),
                          (None, "heads", None)),
        "wo": dense(H * cfg.v_head_dim, cfg.d_model, ("heads", "embed")),
    }


def _latent(p: Dict, x: torch.Tensor, cfg: MLAConfig,
            positions: torch.Tensor):
    """Compressed latent + rope key part for a span of positions."""
    dkv = apply_dense(p["w_dkv"], x)
    c_kv, k_rope = dkv.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = apply_rmsnorm(p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)   # (B,S,rope_dim)
    return c_kv, k_rope


def _queries(p: Dict, x: torch.Tensor, cfg: MLAConfig,
             positions: torch.Tensor):
    B, S, _ = x.shape
    q = apply_dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.qk_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _decompress(c_kv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, R) latents through (R, H, d) -> (B, S, H, d), in f32 (or
    f64 for an f64 model), as the reference's einsum."""
    cf = wide(c_kv)
    B, S, R = c_kv.shape
    y = matmul(cf.reshape(B * S, R), w.to(cf.dtype).reshape(R, -1))
    return y.reshape(B, S, w.shape[1], w.shape[2])


def apply_mla(p: Dict, x: torch.Tensor, cfg: MLAConfig, *,
              causal: bool = True, q_offset: int = 0,
              chunk: int = 1024) -> torch.Tensor:
    """Training/prefill path: decompress K/V, run chunked attention with
    the scale of the qk head dim (128 nope + 64 rope)."""
    B, S, _ = x.shape
    positions = (q_offset + torch.arange(S, device=x.device))[None, :]
    c_kv, k_rope = _latent(p, x, cfg, positions)
    q_nope, q_rope = _queries(p, x, cfg, positions)

    k_nope = _decompress(c_kv, p["w_uk"]).to(x.dtype)
    v = _decompress(c_kv, p["w_uv"]).to(x.dtype)
    k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.n_heads,
                                            cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h.to(x.dtype)], dim=-1)
    o = chunked_attention(q, k, v, causal=causal, chunk=chunk,
                          q_offset=q_offset, scale=cfg.qk_dim ** -0.5)
    return apply_dense(p["wo"], o.reshape(B, S, -1))


# ---------------------------------------------------------------------------
# decode: latent cache + absorbed weights
# ---------------------------------------------------------------------------

def init_mla_cache(cfg: MLAConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device="cpu") -> Dict:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
    }


def apply_mla_decode(p: Dict, x: torch.Tensor, cache: Dict, pos,
                     cfg: MLAConfig, seq_axes=(), lo: int = 0
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token step against the latent cache (weight-absorbed form:
    scores and values both live in the kv_lora latent space), written in
    place.

    ``pos`` is an int (all rows at the same position) or a ``(B,)``
    tensor of per-row positions (continuous-batching ragged decode).
    ``seq_axes`` (bound mesh axes): the cache is this rank's block of
    positions from ``lo`` of a latent sequence-sharded over them; the
    block's owner writes the new row, and the softmax combines the
    blocks (:func:`repro_torch.nn.attention.split_softmax`)."""
    B = x.shape[0]
    positions = decode_positions(pos, B, x.device)
    c_new, kr_new = _latent(p, x, cfg, positions)
    ragged = isinstance(pos, torch.Tensor) and pos.ndim >= 1
    if seq_axes:
        update_cache_block(cache["c_kv"], c_new, pos, lo)
        update_cache_block(cache["k_rope"], kr_new, pos, lo)
    elif ragged:
        rows = torch.arange(B, device=x.device)
        cache["c_kv"][rows, positions[:, 0]] = \
            c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][rows, positions[:, 0]] = \
            kr_new[:, 0].to(cache["k_rope"].dtype)
    else:
        t = int(pos)
        cache["c_kv"][:, t:t + 1] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, t:t + 1] = kr_new.to(cache["k_rope"].dtype)
    k_pos = lo + torch.arange(cache["c_kv"].shape[1], device=x.device)
    mask = k_pos[None] <= positions                            # (B, S)
    o = _latent_attention(p, x, cfg, positions, cache["c_kv"],
                          cache["k_rope"], mask, seq_axes)
    return apply_dense(p["wo"], o), cache


def _latent_attention(p: Dict, x: torch.Tensor, cfg: MLAConfig,
                      positions: torch.Tensor, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, mask: torch.Tensor,
                      seq_axes=()) -> torch.Tensor:
    """Weight-absorbed latent attention over a (gathered) latent cache;
    ``mask`` (B, S) per row.

    Shared by the dense slot path and the paged block-table path — with
    identical ``(c_kv, k_rope, mask)`` operands the outputs are
    bit-identical, which is what makes paged MLA serving exact.  A
    masked position's logit is -1e30, so it contributes exactly 0.
    ``seq_axes``: the latent is this rank's block of a sequence split
    over those mesh axes."""
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope = _queries(p, x, cfg, positions)   # (B,1,H,*)
    qn = wide(q_nope)
    dt = qn.dtype
    # absorb W_uk into the query: q_lat (B, H, 1, R), one row per (lane,
    # head)
    w_uk = p["w_uk"].to(dt).permute(1, 2, 0)          # (H, dn, R)
    q_lat = torch.matmul(qn[:, 0, :, None, :], w_uk)
    c = c_kv.to(dt)                                   # (B, S, R)
    s_lat = torch.matmul(q_lat[:, :, 0], c.transpose(1, 2))   # (B, H, S)
    s_rope = torch.matmul(q_rope[:, 0].to(dt),
                          k_rope.to(dt).transpose(1, 2))
    s = (s_lat + s_rope) * (cfg.qk_dim ** -0.5)
    s = s.masked_fill(~mask[:, None, :], NEG_LOGIT)
    if seq_axes:                                      # (B, H, R) latent
        o_lat = split_softmax(s, c, seq_axes)
    else:
        o_lat = torch.matmul(torch.softmax(s, dim=-1), c)
    w_uv = p["w_uv"].to(dt).permute(1, 0, 2)          # (H, R, dv)
    o = torch.matmul(o_lat[:, :, None, :], w_uv)      # (B, H, 1, dv)
    return o.reshape(B, 1, H * cfg.v_head_dim).to(x.dtype)


# ---------------------------------------------------------------------------
# paged decode: the latent cache as physical pages behind a block table
# ---------------------------------------------------------------------------

def init_paged_mla_cache(cfg: MLAConfig, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device="cpu") -> Dict:
    """Block-major latent cache: pages shared by every request, addressed
    through per-request block tables (see ``nn.attention`` paged
    helpers)."""
    return init_mla_cache(cfg, num_blocks, block_size, dtype, device)


def apply_mla_paged_decode(p: Dict, x: torch.Tensor, cache: Dict,
                           block_table: torch.Tensor, pos: torch.Tensor,
                           cfg: MLAConfig, *, width: int,
                           write_rows: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict]:
    """One-token MLA step against the paged latent cache.

    ``pos`` is (B,) ragged per-row positions; ``width`` is the gather
    width — the dense layer's ``max_seq`` — so the attention operands,
    and hence the outputs, are bit-identical to :func:`apply_mla_decode`
    on the equivalent dense cache.  ``write_rows`` lists the lanes that
    write (None: all; see :func:`repro_torch.nn.attention.
    paged_update_cache`)."""
    positions = pos.long()[:, None]
    c_new, kr_new = _latent(p, x, cfg, positions)
    cache = {
        "c_kv": paged_update_cache(cache["c_kv"], c_new, block_table, pos,
                                   write_rows=write_rows),
        "k_rope": paged_update_cache(cache["k_rope"], kr_new, block_table,
                                     pos, write_rows=write_rows),
    }
    c_g = gather_pages(cache["c_kv"], block_table, width)
    kr_g = gather_pages(cache["k_rope"], block_table, width)
    mask = torch.arange(width, device=x.device)[None] <= positions
    o = _latent_attention(p, x, cfg, positions, c_g, kr_g, mask)
    return apply_dense(p["wo"], o), cache
