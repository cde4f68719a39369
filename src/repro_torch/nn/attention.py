"""GQA attention: projections, full-sequence attention, the masked
one-query softmax, and the dense and paged KV caches.

  * ``chunked_attention`` — training / prefill: the whole sequence in one
    ``ops.flash_attention`` (on the card the hand-written kernel K6);
  * ``decode_attention`` / ``masked_decode_attention`` — one query against
    the KV cache, masked to the current position / sliding window;
  * the paged layout — physical pages shared by every request, addressed
    through per-request block tables.

Sliding windows are a per-layer int with ``NO_WINDOW`` meaning global.
Cache writes happen in place (``index_copy_``): the reference's
functional update would copy the whole cache every step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.dist import collectives as col
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_LOGIT, NO_WINDOW, wide
from repro_torch.nn.core import apply_dense, dense
from repro_torch.nn.layers import tp_reduce


def gqa_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int,
             qkv_bias: bool = False) -> Dict:
    return {
        "wq": dense(d_model, n_heads * head_dim, ("embed", "heads"),
                    bias=qkv_bias),
        "wk": dense(d_model, n_kv * head_dim, ("embed", "kv_heads"),
                    bias=qkv_bias),
        "wv": dense(d_model, n_kv * head_dim, ("embed", "kv_heads"),
                    bias=qkv_bias),
        "wo": dense(n_heads * head_dim, d_model, ("heads", "embed")),
    }


def qkv_project(p: Dict, x: torch.Tensor, n_heads: int, n_kv: int,
                head_dim: int):
    B, S, _ = x.shape
    q = apply_dense(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = apply_dense(p["wk"], x).reshape(B, S, n_kv, head_dim)
    v = apply_dense(p["wv"], x).reshape(B, S, n_kv, head_dim)
    return q, k, v


def out_project(p: Dict, o: torch.Tensor, tp_axis=None,
                sp: bool = False) -> torch.Tensor:
    """``tp_axis`` (explicit tensor parallelism, a bound
    :class:`repro_torch.dist.collectives.Axis`): ``o`` holds this rank's
    head shard, ``wo`` the matching row shard, and the partial output
    projection is assembled by a ``psum`` (``sp``: a ``psum_scatter``
    over the sequence, :func:`repro_torch.nn.layers.tp_reduce`)."""
    B, S, H, D = o.shape
    y = apply_dense(p["wo"], o.reshape(B, S, H * D))
    if tp_axis is not None:
        y = tp_reduce(y, tp_axis, sp)
    return y


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = NO_WINDOW,
                      chunk: int = 1024, q_offset: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0.

    The reference's online softmax over KV chunks, computed by one
    ``ops.flash_attention`` call over the whole key axis (the kernel walks
    its own key tiles); ``chunk`` is kept for the reference's contract
    (``Sk % chunk == 0``).  Returns (B, Sq, H, Dv) in q's type."""
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    assert Sk % chunk == 0, (Sk, chunk)
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=causal,
                            window=int(window), q_offset=q_offset,
                            scale=scale)
    return o.transpose(1, 2)


def masked_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, mask: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """One-query attention against a gathered cache under an explicit mask.

    q: (B, 1, H, D); caches: (B, S, KH, Dv); mask: (S,) shared across rows
    or (B, S) per-row (ragged positions).  This is THE decode softmax —
    the dense slot path and the paged block-table path both call it, so
    their outputs are bit-identical whenever the gathered (k, v, mask)
    triples match.  Masked positions contribute exactly 0.0 whatever the
    cache holds there (their logits become -1e30 and ``exp(-1e30 - m)``
    underflows)."""
    logits, vf = _decode_logits(q, k_cache, v_cache, mask, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    ell = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / ell                              # (B,KH,G,Dv)
    return o.reshape(*q.shape[:3], -1).to(q.dtype)


def _decode_logits(q, k_cache, v_cache, mask, scale):
    """The decode softmax's masked logits (B, KH, G, S) and its values
    (B, KH, S, Dv), in f32 (f64 for an f64 model)."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    qf = wide(q).reshape(B, KH, H // KH, D) * scale            # (B,KH,G,D)
    kf = k_cache.to(qf.dtype).permute(0, 2, 3, 1)              # (B,KH,D,S)
    logits = torch.matmul(qf, kf)                              # (B,KH,G,S)
    maskb = mask[:, None, None, :] if mask.ndim == 2 else mask
    logits = logits.masked_fill(~maskb, NEG_LOGIT)
    return logits, v_cache.to(qf.dtype).permute(0, 2, 1, 3)


def split_softmax(logits: torch.Tensor, values: torch.Tensor,
                  axes) -> torch.Tensor:
    """softmax(logits) @ values where the key axis (the last of
    ``logits``, the one before last of ``values``) is split over the mesh
    ``axes`` (bound :class:`repro_torch.dist.collectives.Axis` objects)
    and this rank holds one block of it (flash-decode's split-S): each
    block's (weighted values, sum, maximum) under its own maximum, one
    all-gather of them, and the blocks combined by log-sum-exp, in
    coordinate order, so every rank gets the same bits.  A masked logit
    (-1e30) adds exactly 0, and so does a block whose every key is
    masked (its maximum lies 1e30 below the others')."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    part = torch.cat([torch.matmul(p, values), p.sum(dim=-1, keepdim=True),
                      m], dim=-1)
    for ax in axes:
        part = col.all_gather(part, ax, 0)
    part = part.reshape(-1, *part.shape[len(axes):])
    w = torch.exp(part[..., -1:] - part[..., -1:].amax(dim=0))
    tot = (part[..., :-1] * w).sum(dim=0)
    return tot[..., :-1] / tot[..., -1:]


def split_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, mask: torch.Tensor, axes,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """:func:`masked_decode_attention` over a cache whose sequence is
    split over ``axes``: ``k_cache``/``v_cache``/``mask`` are this rank's
    block of positions, and every rank gets the whole output
    (:func:`split_softmax`)."""
    logits, vf = _decode_logits(q, k_cache, v_cache, mask, scale)
    o = split_softmax(logits, vf, axes)
    return o.reshape(*q.shape[:3], -1).to(q.dtype)


def decode_positions(pos, batch: int, device) -> torch.Tensor:
    """(B, 1) positions of a decode step from an int (every row at one
    position) or a per-row ``(B,)`` tensor."""
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        return pos.long()[:, None]
    return torch.full((batch, 1), int(pos), dtype=torch.long, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int = NO_WINDOW,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, S, KH, D); pos: index of the current
    token.  One masked softmax over the cache (linear per step)."""
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = (k_pos <= pos) & (k_pos > pos - window)
    return masked_decode_attention(q, k_cache, v_cache, mask, scale=scale)


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, 1, KH, D) into (B, S, KH, D) at ``pos``, in place.

    ``pos`` is an int (every row writes the same position — the
    static-batch generate path) or a ``(B,)`` tensor (each row writes its
    own position — the continuous-batching ragged path).  Returns
    ``cache``."""
    new = new.to(cache.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = new[:, 0]
    else:
        p = int(pos)
        cache[:, p:p + 1] = new
    return cache


def update_cache_block(cache: torch.Tensor, new: torch.Tensor, pos,
                       lo: int) -> torch.Tensor:
    """:func:`update_cache` on a block of a sequence-sharded cache that
    holds positions ``lo .. lo + S - 1``: a row writes only where its
    position lies in the block (each lane its own under ragged
    ``pos``).  Returns ``cache``."""
    new = new.to(cache.dtype)
    S = cache.shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        p = pos.long() - lo
        hit = (p >= 0) & (p < S)
        rows = torch.arange(cache.shape[0], device=cache.device)
        at = p.clamp(0, S - 1)
        keep = cache[rows, at]
        cache[rows, at] = torch.where(hit.view(-1, *[1] * (keep.ndim - 1)),
                                      new[:, 0], keep)
    elif 0 <= int(pos) - lo < S:
        p = int(pos) - lo
        cache[:, p:p + 1] = new
    return cache


# ---------------------------------------------------------------------------
# paged KV: physical pages indexed through per-request block tables
# ---------------------------------------------------------------------------
#
# The paged layout stores KV block-major — ``pages`` is
# ``(num_blocks, block_size, *rest)`` shared by every request — and each
# request addresses its sequence through a row of physical block ids
# (``block_table``: (B, blocks_per_slot), padded with 0 past the granted
# blocks; reads there are masked, writes suppressed).  Absolute position
# ``p`` of row ``b`` lives at page slot
# ``(block_table[b, p // block_size], p % block_size)``.


def paged_flat_index(block_table: torch.Tensor, pos: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """(B,) flattened page-slot index of absolute position ``pos`` per row
    (into ``pages.reshape(num_blocks * block_size, ...)``)."""
    pos = pos.long()
    blk = block_table.long().gather(1, (pos // block_size)[:, None])[:, 0]
    return blk * block_size + pos % block_size


def paged_update_cache(pages: torch.Tensor, new: torch.Tensor,
                       block_table: torch.Tensor, pos: torch.Tensor, *,
                       write_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Write ``new`` (B, 1, *rest) into block-major ``pages``
    (num_blocks, block_size, *rest) at per-row absolute positions
    ``pos``, in place; returns ``pages``.

    ``write_rows`` lists the lanes that write (None: all of them).  The
    reference takes a (B,) mask and drops the other lanes' writes with an
    out-of-range scatter; PyTorch has no dropping scatter, so the caller
    turns the mask into row indices once per pass
    (:func:`repro_torch.serve.decode.paged_decode_step`).  Writing lanes
    target distinct page slots by construction (each writes into a block
    its request owns alone — copy-on-write forks shared blocks first)."""
    N, bs = pages.shape[:2]
    flat = paged_flat_index(block_table, pos, bs)
    vals = new[:, 0]
    if write_rows is not None:
        flat, vals = flat[write_rows], vals[write_rows]
    pages.view(N * bs, *pages.shape[2:]).index_copy_(0, flat,
                                                     vals.to(pages.dtype))
    return pages


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Gather absolute positions ``[0, width)`` of every row:
    (B, width, *rest).  ``width`` may be below the table's coverage
    (``max_seq`` not a multiple of ``block_size``) — the tail page slots
    are never put into the attention operand, keeping the contraction
    width identical to the dense layer's cache."""
    B, nb = block_table.shape
    bs = pages.shape[1]
    g = pages[block_table.long()].reshape(B, nb * bs, *pages.shape[2:])
    return g[:, :width]


def gather_page_window(pages: torch.Tensor, block_table: torch.Tensor,
                       pos: torch.Tensor, width: int) -> torch.Tensor:
    """Gather the trailing window — absolute positions
    ``pos - width + 1 .. pos`` per row — as (B, width, *rest).

    This reconstructs exactly what the dense sliding-window ring buffer
    holds after its shift-and-append, so windowed layers stay bit-exact
    under paging.  Negative positions clamp to 0; callers mask them, and
    masked garbage contributes exactly 0."""
    N, bs = pages.shape[:2]
    offs = torch.arange(width, device=pos.device) - (width - 1)
    abs_pos = (pos.long()[:, None] + offs[None, :]).clamp_min(0)  # (B, W)
    blk = block_table.long().gather(1, abs_pos // bs)
    flat = blk * bs + abs_pos % bs
    return pages.reshape(N * bs, *pages.shape[2:])[flat]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           pos: torch.Tensor, *, window: int = NO_WINDOW,
                           width: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention through the block table.

    q: (B, 1, H, D); k/v pages: (num_blocks, block_size, KH, D);
    block_table: (B, blocks_per_slot) physical ids; pos: (B,) per-row
    ragged positions.  Bounded windows gather the ``width``-sized trailing
    window, global attention gathers absolute positions ``[0, width)``.
    The gathered operands — and hence the outputs — are bit-identical to
    the dense slot path's whenever ``width`` matches the dense layer's
    cache length."""
    positions = pos.long()[:, None]
    if window < NO_WINDOW and width is not None and width <= window:
        S = width
        k_g = gather_page_window(k_pages, block_table, pos, S)
        v_g = gather_page_window(v_pages, block_table, pos, S)
        offs = torch.arange(S, device=pos.device)[None]
        mask = (positions - (S - 1) + offs) >= 0
    else:
        S = width if width is not None \
            else block_table.shape[1] * k_pages.shape[1]
        k_g = gather_pages(k_pages, block_table, S)
        v_g = gather_pages(v_pages, block_table, S)
        k_positions = torch.arange(S, device=pos.device)[None]
        mask = (k_positions <= positions) & (k_positions > positions - window)
    return masked_decode_attention(q, k_g, v_g, mask, scale=scale)
