"""Serving: KV caches + single-token decode steps for every family.

Decode is unrolled over layers: each layer owns its cache dict, so
per-layer cache shapes can differ — gemma's local layers keep a bounded
``window``-sized ring buffer while its global layers keep the full
sequence; MLA layers (deepseek) keep the compressed latent and the rope
key; mamba layers keep an O(1) recurrent state and conv tail; the
hybrid (zamba2) keeps one per Mamba-2 layer, then one attention cache
per application of its shared block.  An moe model's leading dense
layers (``first_dense_layers``) come from ``dense_layers``, the rest
from ``layers``, whose MLP is the MoE.  The encoder-decoder (whisper)
keeps per decoder layer a self-attention cache and the cross caches
``ck``/``cv`` of ``ENC_LEN_DECODE`` encoder frames, zeros until a caller
writes the encoder's keys and values there (the reference's contract:
nothing in serving runs the encoder); paged serving refuses it.

Absolute caches and pages are written in place (the reference's
functional update copies); a ring buffer is rebuilt by its
shift-and-append, and a recurrent cache by its step, which are copies
either way.  Each step returns the cache list it updated, as the
reference does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (_apply_mlp, _apply_norm, embed_forward,
                                   head_forward, mla_config, moe_config,
                                   ssm_config, window_schedule)
from repro_torch.nn.attention import (NO_WINDOW, decode_positions,
                                      masked_decode_attention,
                                      paged_decode_attention,
                                      paged_update_cache)
from repro_torch.nn.core import apply_dense, torch_dtype
from repro_torch.nn.mla import (apply_mla_decode, apply_mla_paged_decode,
                                init_mla_cache)
from repro_torch.nn.moe import apply_moe
from repro_torch.nn.ssm import apply_ssm_decode, init_ssm_cache


def _layer_params(stacked: Dict, i: int) -> Dict:
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def _device(params: Dict) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, batch: int, length: int, device) -> Dict:
    """A K/V cache of ``length`` positions a row (pages: ``batch`` pages
    of ``length`` positions); for MLA the latent and rope-key cache."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.mla:
        return init_mla_cache(mla_config(cfg), batch, length, dtype, device)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ssm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    return init_ssm_cache(ssm_config(cfg), batch, torch_dtype(cfg.dtype),
                          device)


def _n_shared(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared block (0 for other families)."""
    return (cfg.n_layers // cfg.shared_attn_every
            if cfg.family == "hybrid" else 0)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device="cpu") -> List:
    """One cache dict per layer: ``max_seq`` positions for global layers,
    ``min(window, max_seq)`` for windowed (ring-buffer) layers (an MLA
    layer's latent cache holds ``max_seq``); for ssm and hybrid one
    recurrent cache per Mamba-2 layer, then (hybrid) one ``max_seq``
    attention cache per application of the shared block; for encdec one
    ``max_seq`` cache per decoder layer with the cross caches ``ck`` and
    ``cv`` of ``ENC_LEN_DECODE`` frames, zero-filled."""
    if cfg.family == "encdec":
        from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
        shape = (batch, ENC_LEN_DECODE, cfg.n_kv_heads, cfg.head_dim)
        dtype = torch_dtype(cfg.dtype)
        return [{**_attn_cache(cfg, batch, max_seq, device),
                 "ck": torch.zeros(shape, dtype=dtype, device=device),
                 "cv": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(cfg.dec_layers)]
    if cfg.family in ("dense", "moe"):
        return [_attn_cache(cfg, batch,
                            max_seq if w >= NO_WINDOW or cfg.mla
                            else min(int(w), max_seq), device)
                for w in window_schedule(cfg)]
    return ([_ssm_cache(cfg, batch, device) for _ in range(cfg.n_layers)]
            + [_attn_cache(cfg, batch, max_seq, device)
               for _ in range(_n_shared(cfg))])


def _paged_family(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise ValueError(
            f"paged serving does not support family {cfg.family!r}")


def paged_cache_kinds(cfg: ModelConfig) -> List[str]:
    """Per-cache-entry layout under paging, parallel to the cache list:
    ``"paged"`` — block-major physical pages addressed through the block
    table (attention K/V, MLA latent); ``"slot"`` — per-slot rows
    gathered and scattered by slot index (recurrent SSM/conv state has no
    sequence dimension to page)."""
    _paged_family(cfg)
    if cfg.family in ("dense", "moe"):
        return ["paged"] * cfg.n_layers
    return ["slot"] * cfg.n_layers + ["paged"] * _n_shared(cfg)


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      num_slots: int, device="cpu") -> List:
    """Block-major caches for the paged serve path: every attention entry
    holds ``num_blocks`` physical pages of ``block_size`` positions
    shared by every request — memory scales with the KV budget, not
    ``num_slots × max_seq``.  Windowed layers store absolute positions
    too (their ring is rebuilt by a trailing-window gather).  Recurrent
    entries keep ``num_slots + 1`` per-slot rows (the scratch row
    included), as the dense path does."""
    return [_ssm_cache(cfg, num_slots + 1, device) if kind == "slot"
            else _attn_cache(cfg, num_blocks, block_size, device)
            for kind in paged_cache_kinds(cfg)]


# ---------------------------------------------------------------------------
# per-layer decode attention
# ---------------------------------------------------------------------------

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
    positions = decode_positions(pos, B, x.device)
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
    positions = decode_positions(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    k_pages = paged_update_cache(cache["k"], k, block_table, pos,
                                 write_rows=write_rows)
    v_pages = paged_update_cache(cache["v"], v, block_table, pos,
                                 write_rows=write_rows)
    width = max_seq if window >= NO_WINDOW else min(window, max_seq)
    o = paged_decode_attention(q, k_pages, v_pages, block_table, pos,
                               window=window, width=width)
    return nn.out_project(p, o), {"k": k_pages, "v": v_pages}


def _cross_decode(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                  cache: Dict) -> torch.Tensor:
    """One query of each row against all of its cache's ``ck`` / ``cv``
    frames: the biased q projection (no rope), then the decode softmax
    under an all-ones mask."""
    B = h.shape[0]
    q = apply_dense(p["wq"], h).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    mask = torch.ones(cache["ck"].shape[1], dtype=torch.bool,
                      device=h.device)
    return nn.out_project(p, masked_decode_attention(q, cache["ck"],
                                                     cache["cv"], mask))


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _as_tokens(token, device) -> torch.Tensor:
    return torch.as_tensor(token, device=device).long()


def _attn_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor, caches: List,
              ci: int, window: int, attend) -> torch.Tensor:
    """A dense or moe block's decode: attention through ``attend`` on
    cache ``ci`` (updated in ``caches``), then the MLP, or the MoE where
    the block has one."""
    a, caches[ci] = attend(p["attn"], _apply_norm(cfg, p["ln1"], x),
                           caches[ci], window)
    x = x + a
    h = _apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        return x + apply_moe(p["moe"], h, moe_config(cfg))
    return x + _apply_mlp(cfg, p["mlp"], h)


def _decode_layers(params: Dict, caches: List, x: torch.Tensor,
                   cfg: ModelConfig, attend) -> Tuple[torch.Tensor, List]:
    """The layers of one decode step, ``attend(p, h, cache, window)``
    giving an attention layer's output and its updated cache.  SSM layers
    carry no position: they advance one step per call, whatever ``pos``
    their attention layers see.  The hybrid's shared block writes cache
    ``n_layers + g`` after group ``g``, unwindowed.  An moe model's
    first ``first_dense_layers`` layers come from ``dense_layers``.  An
    encdec decoder layer attends to itself, then to its cache's ``ck`` /
    ``cv`` under an all-ones mask, then runs its MLP."""
    new = list(caches)
    if cfg.family == "encdec":
        for li in range(cfg.dec_layers):
            p = _layer_params(params["dec_layers"], li)
            a, new[li] = attend(p["attn"], _apply_norm(cfg, p["ln1"], x),
                                caches[li], NO_WINDOW)
            x = x + a
            x = x + _cross_decode(cfg, p["cross"],
                                  _apply_norm(cfg, p["ln_x"], x), caches[li])
            x = x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x))
        return x, new
    if cfg.family in ("dense", "moe"):
        head = cfg.first_dense_layers if cfg.family == "moe" else 0
        for li, win in enumerate(window_schedule(cfg)):
            p = (_layer_params(params["dense_layers"], li) if li < head
                 else _layer_params(params["layers"], li - head))
            x = _attn_mlp(cfg, p, x, new, li, int(win), attend)
        return x, new
    scfg = ssm_config(cfg)
    for li in range(cfg.n_layers):
        p = _layer_params(params["layers"], li)
        y, new[li] = apply_ssm_decode(p["ssm"], _apply_norm(cfg, p["ln1"], x),
                                      caches[li], scfg)
        x = x + y
        if cfg.family == "hybrid" and (li + 1) % cfg.shared_attn_every == 0:
            x = _attn_mlp(cfg, params["shared_block"], x, new,
                          cfg.n_layers + li // cfg.shared_attn_every,
                          NO_WINDOW, attend)
    return x, new


def decode_step(params: Dict, caches: List, token, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int -> logits (B, vocab) f32; updates caches.

    ``pos`` is an int (all rows decode the same position — the static
    generate path) or a ``(B,)`` int tensor of per-row positions (the
    continuous-batching ragged path; each row reads/writes its own cache
    position)."""
    device = _device(params)
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        pos = pos.to(device)
    x = embed_forward(params, _as_tokens(token, device), cfg)

    def attend(p, h, cache, window):
        if cfg.mla:
            return apply_mla_decode(p, h, cache, pos, mla_config(cfg))
        return _attn_decode(cfg, p, h, cache, pos, window)

    x, new_caches = _decode_layers(params, caches, x, cfg, attend)
    return head_forward(params, x, cfg)[:, 0], new_caches


def paged_decode_step(params: Dict, caches: List, block_table, token, pos,
                      write_mask, cfg: ModelConfig,
                      max_seq: int) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int -> logits (B, vocab) f32 through the block table.

    The paged analogue of :func:`decode_step`: ``"paged"`` cache entries
    (see :func:`paged_cache_kinds`) are the full block-major page arrays,
    and every lane reads/writes its own pages through its
    ``block_table`` row at its own ragged ``pos``; ``"slot"`` entries
    arrive already gathered to (B, ...) rows (the engine scatters them
    back).  ``write_mask`` (B,) suppresses the page write for idle lanes
    and for shared-prefix re-run passes whose target position is owned
    by a shared block (the stored value is bit-identical, so skipping the
    write avoids a spurious copy-on-write fork).  The mask becomes lane
    indices on the host once per pass (a host sync if it lies on the
    card; the engine hands it over from the host)."""
    _paged_family(cfg)
    device = _device(params)
    block_table = torch.as_tensor(block_table, device=device)
    pos = torch.as_tensor(pos, device=device)
    rows = torch.nonzero(torch.as_tensor(write_mask).cpu()).squeeze(1)
    write_rows = None if len(rows) == len(pos) else rows.to(device)
    x = embed_forward(params, _as_tokens(token, device), cfg)

    def attend(p, h, cache, window):
        if cfg.mla:
            return apply_mla_paged_decode(p, h, cache, block_table, pos,
                                          mla_config(cfg), width=max_seq,
                                          write_rows=write_rows)
        return _attn_decode_paged(cfg, p, h, cache, block_table, pos,
                                  window, max_seq, write_rows)

    x, new_caches = _decode_layers(params, caches, x, cfg, attend)
    return head_forward(params, x, cfg)[:, 0], new_caches
