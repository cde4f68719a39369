"""Serving: KV caches + single-token decode steps, dense family.

Decode is unrolled over layers: each layer owns its cache dict, so
per-layer cache shapes can differ — gemma's local layers keep a bounded
``window``-sized ring buffer while its global layers keep the full
sequence.

Absolute caches and pages are written in place (the reference's
functional update copies); a ring buffer is rebuilt by its
shift-and-append, which is a copy either way.  Each step returns the
cache list it updated, as the reference does.  The moe, ssm, hybrid and
encdec families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (_apply_mlp, _apply_norm, embed_forward,
                                   head_forward, require_family,
                                   window_schedule)
from repro_torch.nn.attention import (NO_WINDOW, masked_decode_attention,
                                      paged_decode_attention,
                                      paged_update_cache)
from repro_torch.nn.core import torch_dtype


def _layer_params(stacked: Dict, i: int) -> Dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def _device(params: Dict) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, batch: int, length: int, device) -> Dict:
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device="cpu") -> List:
    """One cache dict per layer: ``max_seq`` positions for global layers,
    ``min(window, max_seq)`` for windowed (ring-buffer) layers."""
    require_family(cfg, "init_caches")
    caches = []
    for w in window_schedule(cfg):
        length = max_seq if w >= NO_WINDOW else min(int(w), max_seq)
        caches.append(_attn_cache(cfg, batch, length, device))
    return caches


def paged_cache_kinds(cfg: ModelConfig) -> List[str]:
    """Per-cache-entry layout under paging, parallel to the cache list:
    ``"paged"`` — block-major physical pages addressed through the block
    table.  (The reference's ``"slot"`` kind, recurrent state gathered by
    slot, arrives with the ssm and hybrid families.)"""
    require_family(cfg, "paged_cache_kinds")
    return ["paged"] * cfg.n_layers


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      num_slots: int, device="cpu") -> List:
    """Block-major caches for the paged serve path: every layer holds
    ``num_blocks`` physical pages of ``block_size`` positions shared by
    every request — memory scales with the KV budget, not
    ``num_slots × max_seq``.  Windowed layers store absolute positions
    too (their ring is rebuilt by a trailing-window gather)."""
    return [_attn_cache(cfg, num_blocks, block_size, device)
            for _ in paged_cache_kinds(cfg)]


# ---------------------------------------------------------------------------
# per-layer decode attention
# ---------------------------------------------------------------------------

def _positions(pos, batch: int, device) -> torch.Tensor:
    """(B, 1) rope positions from an int or per-row ``(B,)`` pos."""
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        return pos.long()[:, None]
    return torch.full((batch, 1), int(pos), dtype=torch.long, device=device)


def _project_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor):
    """The decode-step q/k/v projection (+qk-norm, +rope) — shared by the
    dense slot path and the paged block-table path so both produce
    bit-identical per-token K/V before the cache write."""
    q, k, v = nn.qkv_project(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = nn.apply_rmsnorm(p["q_norm"], q)
        k = nn.apply_rmsnorm(p["k_norm"], k)
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict,
                 pos, window: int) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); ring buffer for local windows, absolute cache else.

    ``pos`` is an int (all rows at the same position — static batch) or
    a ``(B,)`` tensor (ragged rows — continuous batching), in which case
    the key mask becomes per-row ``(B, S)``."""
    B = x.shape[0]
    positions = _positions(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)

    ragged = isinstance(pos, torch.Tensor) and pos.ndim >= 1
    S = cache["k"].shape[1]
    ar = torch.arange(S, device=x.device)
    if window < NO_WINDOW and S <= window:
        k_cache = torch.cat([cache["k"][:, 1:], k.to(cache["k"].dtype)], dim=1)
        v_cache = torch.cat([cache["v"][:, 1:], v.to(cache["v"].dtype)], dim=1)
        if ragged:
            mask = (positions - (S - 1) + ar[None]) >= 0            # (B,S)
        else:
            mask = (int(pos) - (S - 1) + ar) >= 0
    else:
        k_cache = nn.update_cache(cache["k"], k, pos)
        v_cache = nn.update_cache(cache["v"], v, pos)
        if ragged:
            mask = (ar[None] <= positions) & (ar[None] > positions - window)
        else:
            mask = (ar <= int(pos)) & (ar > int(pos) - window)

    o = masked_decode_attention(q, k_cache, v_cache, mask)
    return nn.out_project(p, o), {**cache, "k": k_cache, "v": v_cache}


def _attn_decode_paged(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       cache: Dict, block_table: torch.Tensor,
                       pos: torch.Tensor, window: int, max_seq: int,
                       write_rows: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict]:
    """The paged analogue of :func:`_attn_decode`: write this token's K/V
    into the physical pages through the block table, then attend over a
    gather whose width matches the dense layer's cache length — so the
    outputs are bit-identical to the slot path's."""
    B = x.shape[0]
    positions = _positions(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    k_pages = paged_update_cache(cache["k"], k, block_table, pos,
                                 write_rows=write_rows)
    v_pages = paged_update_cache(cache["v"], v, block_table, pos,
                                 write_rows=write_rows)
    width = max_seq if window >= NO_WINDOW else min(window, max_seq)
    o = paged_decode_attention(q, k_pages, v_pages, block_table, pos,
                               window=window, width=width)
    return nn.out_project(p, o), {"k": k_pages, "v": v_pages}


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _as_tokens(token, device) -> torch.Tensor:
    return torch.as_tensor(token, device=device).long()


def decode_step(params: Dict, caches: List, token, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int -> logits (B, vocab) f32; updates caches.

    ``pos`` is an int (all rows decode the same position — the static
    generate path) or a ``(B,)`` int tensor of per-row positions (the
    continuous-batching ragged path; each row reads/writes its own cache
    position)."""
    require_family(cfg, "decode_step")
    device = _device(params)
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        pos = pos.to(device)
    x = embed_forward(params, _as_tokens(token, device), cfg)
    new_caches = list(caches)
    for li, win in enumerate(window_schedule(cfg)):
        p = _layer_params(params["layers"], li)
        h = _apply_norm(cfg, p["ln1"], x)
        a, new_caches[li] = _attn_decode(cfg, p["attn"], h, caches[li], pos,
                                         int(win))
        x = x + a
        x = x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x))
    return head_forward(params, x, cfg)[:, 0], new_caches


def paged_decode_step(params: Dict, caches: List, block_table, token, pos,
                      write_mask, cfg: ModelConfig,
                      max_seq: int) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int -> logits (B, vocab) f32 through the block table.

    The paged analogue of :func:`decode_step`: every cache entry is the
    full block-major page array, and every lane reads/writes its own
    pages through its ``block_table`` row at its own ragged ``pos``.
    ``write_mask`` (B,) suppresses the page write for idle lanes and for
    shared-prefix re-run passes whose target position is owned by a
    shared block (the stored value is bit-identical, so skipping the
    write avoids a spurious copy-on-write fork).  The mask becomes lane
    indices on the host once per pass (a host sync if it lies on the
    card; the engine hands it over from the host)."""
    require_family(cfg, "paged_decode_step")
    device = _device(params)
    block_table = torch.as_tensor(block_table, device=device)
    pos = torch.as_tensor(pos, device=device)
    rows = torch.nonzero(torch.as_tensor(write_mask).cpu()).squeeze(1)
    write_rows = None if len(rows) == len(pos) else rows.to(device)
    x = embed_forward(params, _as_tokens(token, device), cfg)
    new_caches = list(caches)
    for li, win in enumerate(window_schedule(cfg)):
        p = _layer_params(params["layers"], li)
        h = _apply_norm(cfg, p["ln1"], x)
        a, new_caches[li] = _attn_decode_paged(
            cfg, p["attn"], h, caches[li], block_table, pos, int(win),
            max_seq, write_rows)
        x = x + a
        x = x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x))
    return head_forward(params, x, cfg)[:, 0], new_caches
