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

``mesh`` (serving with a mesh; every rank runs the step): ``params``
holds this rank's blocks by ``dist.sharding.param_shardings``, each
cache entry its block by ``specs`` (``decode_cache_shardings``, or
``kv_pool_shardings`` for the engine's pool), and ``token``/``pos`` the
rows of the caches' batch block.  No cache block is ever gathered: a
KV cache sharded by heads attends this rank's query heads (GQA groups
are contiguous) and its output projection psums over ``model``; one
sharded by the sequence (MQA, or a batch the data axes do not divide)
attends every head over this rank's positions and the blocks combine
by log-sum-exp (:func:`repro_torch.nn.attention.split_softmax`), the
block holding a row's position writes it, and a ring buffer's shift
moves each block's first row to its left neighbour; an MLA latent
splits the same way; an SSM state updates its heads and a conv tail
its channels (:func:`repro_torch.nn.ssm.apply_ssm_decode`).  Each
layer's parameters are all-gathered for use (FSDP over ``data``), over
``model`` too except the head-sharded attention, the MLP's columns
(psummed) and the experts (:func:`repro_torch.nn.apply_moe` takes
``apply_moe_ep_replicated`` for one token a lane).  The embedding and
the head run on this rank's vocabulary block: the lookup psums, the
logits are all-gathered, so every rank takes the same argmax.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist import sharding as shd
from repro_torch.models.lm import (Placement, _apply_mlp, _apply_norm,
                                   _layer_specs, embed_forward, head_forward,
                                   head_weight, mla_config, moe_config,
                                   scale_embedding, ssm_config, vocab_embed,
                                   vocab_gather, vocab_logits,
                                   window_schedule)
from repro_torch.nn.attention import (NO_WINDOW, decode_positions,
                                      masked_decode_attention,
                                      paged_decode_attention,
                                      paged_update_cache,
                                      split_decode_attention,
                                      update_cache_block)
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

def _heads(cfg: ModelConfig, p: Dict) -> int:
    """The heads a projection holds (this rank's, under a mesh)."""
    return p["w"].shape[1] // cfg.head_dim


def _project_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor):
    """The decode-step q/k/v projection (+qk-norm, +rope) — shared by the
    dense slot path and the paged block-table path so both produce
    bit-identical per-token K/V before the cache write."""
    q, k, v = nn.qkv_project(p, x, _heads(cfg, p["wq"]),
                             _heads(cfg, p["wk"]), cfg.head_dim)
    if cfg.qk_norm:
        q = nn.apply_rmsnorm(p["q_norm"], q)
        k = nn.apply_rmsnorm(p["k_norm"], k)
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


class _Layout:
    """Where this rank's block of a cache leaf lies: ``heads`` — the
    ``model`` axis its heads are sharded over (None: whole); ``seq`` —
    the axes its sequence is split over, this block holding positions
    ``lo .. lo + S - 1`` of ``total``.  A mesh-less cache is whole."""

    def __init__(self, heads=None, seq=(), lo: int = 0,
                 total: Optional[int] = None):
        self.heads, self.seq, self.lo, self.total = heads, seq, lo, total

    @classmethod
    def of(cls, mesh, spec, shape, heads_dim: Optional[int] = 2):
        """The layout of a block of ``shape`` placed by ``spec`` (batch,
        sequence, [heads, ...])."""
        heads = None
        if heads_dim is not None and "model" in shd.entry_axes(
                spec[heads_dim]) and mesh.shape["model"] > 1:
            heads = mesh.axis("model")
        seq = shd.live_axes(mesh, spec[1])
        idx, n = shd.block_index(mesh, spec[1])
        return cls(heads, seq, idx * shape[1], n * shape[1])


_WHOLE = _Layout()


def _attn_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict,
                 pos, window: int,
                 lay: _Layout = _WHOLE) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); ring buffer for local windows, absolute cache else.

    ``pos`` is an int (all rows at the same position — static batch) or
    a ``(B,)`` tensor (ragged rows — continuous batching), in which case
    the key mask becomes per-row ``(B, S)``.  ``lay``: the cache's block
    under a mesh (see the module docstring)."""
    B = x.shape[0]
    positions = decode_positions(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)

    ragged = isinstance(pos, torch.Tensor) and pos.ndim >= 1
    S = cache["k"].shape[1]
    total = lay.total or S
    ar = lay.lo + torch.arange(S, device=x.device)
    if window < NO_WINDOW and total <= window:
        k_new, v_new = k, v
        if lay.seq:
            # each block's first row moves to the block before it; the
            # last block takes the new row
            nxt = col.shift_down(torch.cat([cache["k"][:, :1],
                                            cache["v"][:, :1]], dim=-1),
                                 lay.seq)
            if lay.lo + S < total:
                k_new, v_new = nxt.split(cache["k"].shape[-1], dim=-1)
        k_cache = torch.cat([cache["k"][:, 1:], k_new.to(cache["k"].dtype)],
                            dim=1)
        v_cache = torch.cat([cache["v"][:, 1:], v_new.to(cache["v"].dtype)],
                            dim=1)
        if ragged:
            mask = (positions - (total - 1) + ar[None]) >= 0        # (B,S)
        else:
            mask = (int(pos) - (total - 1) + ar) >= 0
    else:
        if lay.seq:
            k_cache = update_cache_block(cache["k"], k, pos, lay.lo)
            v_cache = update_cache_block(cache["v"], v, pos, lay.lo)
        else:
            k_cache = nn.update_cache(cache["k"], k, pos)
            v_cache = nn.update_cache(cache["v"], v, pos)
        if ragged:
            mask = (ar[None] <= positions) & (ar[None] > positions - window)
        else:
            mask = (ar <= int(pos)) & (ar > int(pos) - window)

    o = (split_decode_attention(q, k_cache, v_cache, mask, lay.seq)
         if lay.seq else masked_decode_attention(q, k_cache, v_cache, mask))
    return (nn.out_project(p, o, tp_axis=lay.heads),
            {**cache, "k": k_cache, "v": v_cache})


def _attn_decode_paged(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       cache: Dict, block_table: torch.Tensor,
                       pos: torch.Tensor, window: int, max_seq: int,
                       write_rows: Optional[torch.Tensor],
                       heads_axis=None) -> Tuple[torch.Tensor, Dict]:
    """The paged analogue of :func:`_attn_decode`: write this token's K/V
    into the physical pages through the block table, then attend over a
    gather whose width matches the dense layer's cache length — so the
    outputs are bit-identical to the slot path's.  ``heads_axis``: the
    pages hold this rank's block of KV heads."""
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
    return (nn.out_project(p, o, tp_axis=heads_axis),
            {"k": k_pages, "v": v_pages})


def _cross_decode(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                  cache: Dict, lay: _Layout = _WHOLE) -> torch.Tensor:
    """One query of each row against all of its cache's ``ck`` / ``cv``
    frames: the biased q projection (no rope), then the decode softmax
    under an all-ones mask (``lay``: the cross caches' block)."""
    B = h.shape[0]
    q = apply_dense(p["wq"], h).reshape(B, 1, _heads(cfg, p["wq"]),
                                        cfg.head_dim)
    mask = torch.ones(cache["ck"].shape[1], dtype=torch.bool,
                      device=h.device)
    o = (split_decode_attention(q, cache["ck"], cache["cv"], mask, lay.seq)
         if lay.seq else
         masked_decode_attention(q, cache["ck"], cache["cv"], mask))
    return nn.out_project(p, o, tp_axis=lay.heads)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _as_tokens(token, device) -> torch.Tensor:
    return torch.as_tensor(token, device=device).long()


class _OnMesh:
    """What one decode step on a mesh needs: the parameters' placement
    (:class:`repro_torch.models.lm.Placement`), and where each cache
    entry's blocks lie (``specs``, parallel to ``caches``)."""

    def __init__(self, cfg: ModelConfig, mesh, caches: List, specs):
        from repro_torch.launch.mesh import require_group
        require_group()
        if specs is None:
            raise ValueError("a decode step on a mesh needs the caches' "
                             "specs (specs=, decode_cache_shardings or "
                             "kv_pool_shardings of the global caches)")
        from repro_torch.models import encdec, lm
        model = encdec if cfg.family == "encdec" else lm
        self.cfg, self.mesh = cfg, mesh
        self.place = Placement(cfg, mesh, 1, model.model_spec(cfg))
        self.tp = self.place.tp
        self._layer_specs: Dict = {}
        self.ssm_keep = set()
        # the batch's entry where it shards the batch over the data axes
        batch = next(iter(specs[0].values()))[0]
        self.batch = batch if shd.live_axes(mesh, batch) else None
        self.lays: List[Dict] = []
        for c, sp in zip(caches, specs):
            if "state" in c:          # SSM: heads of the state, channels
                if shd.live_axes(mesh, sp["conv"][1]):   # of the conv tail
                    raise NotImplementedError(
                        "a conv tail sharded on its window")
                self.lays.append({"heads_axis": self._model(sp["state"][1]),
                                  "channels_axis":
                                      self._model(sp["conv"][2])})
            else:
                self.lays.append({k: _Layout.of(
                    mesh, sp[k], tuple(a.shape), 2 if a.ndim == 4 else None)
                    for k, a in c.items()})
        if cfg.family in ("ssm", "hybrid"):
            self._ssm_params()

    def _model(self, entry):
        """The ``model`` axis where ``entry`` shards over it, else None."""
        return self.tp if self.tp is not None and "model" in \
            shd.entry_axes(entry) else None

    def _ssm_params(self):
        """The Mamba-2 layers' ``model`` blocks that decode computes on:
        ``in_proj``'s columns, ``out_proj``'s rows, and the conv
        weights' channels where the conv tail holds the same block."""
        specs = _layer_specs(self.place.specs["layers"])["ssm"]
        self.ssm_axes = {"in_axis": self._model(specs["in_proj"]["w"][1]),
                         "out_axis": self._model(specs["out_proj"]["w"][0])}
        self.ssm_keep = {k for k, v in (("in_proj", "in_axis"),
                                        ("out_proj", "out_axis"))
                         if self.ssm_axes[v] is not None}
        if self._model(specs["conv_w"][1]) is not None:
            self.ssm_keep |= {"conv_w", "conv_b"}

    def ssm(self, ci: int) -> Dict:
        """``apply_ssm_decode``'s axes for cache entry ``ci``."""
        lay = self.lays[ci]
        if (lay["channels_axis"] is None) != ("conv_w" not in self.ssm_keep):
            raise NotImplementedError("conv weights and tail sharded apart")
        return {**self.ssm_axes, **lay}

    def heads(self, ci: int, key: str = "k") -> bool:
        lay = self.lays[ci].get(key)
        return lay is not None and lay.heads is not None

    def gather(self, p: Dict, specs: Dict, ci: Optional[int]) -> Dict:
        """A block's parameters for use: an attention over a head-sharded
        cache (entry ``ci``) keeps its ``model`` shards, as do the MLP's
        columns and the experts (``Placement``'s rule); everything else
        is gathered whole."""
        def walk(node, spec, tp, path):
            if isinstance(node, dict):
                return {k: walk(node[k], spec[k], tp, path + (k,))
                        for k in node}
            keep = ("model",) if (tp and self.place._keeps_model(
                path, spec)) or (path[0] == "ssm" and path[1]
                                 in self.ssm_keep) else ()
            return shd.gather_for_use(node, spec, self.mesh, keep)

        out = {}
        for k, v in p.items():
            if k in ("attn", "cross"):
                tp = ci is not None and self.heads(
                    ci, "k" if k == "attn" else "ck")
                # the rule reads an attention's leaves by their path
                out[k] = walk(v, specs[k], tp, ("attn",))
            else:
                out[k] = walk(v, specs[k], k in ("mlp", "moe"), (k,))
        return out

    def layer(self, params: Dict, key: str, li: int,
              ci: Optional[int]) -> Dict:
        if key not in self._layer_specs:
            self._layer_specs[key] = _layer_specs(self.place.specs[key])
        return self.gather(_layer_params(params[key], li),
                           self._layer_specs[key], ci)

    def mlp_axis(self, p: Dict):
        """``model`` where the MLP holds a column shard (its product is
        then psummed), else None."""
        w = p["up" if self.cfg.mlp == "gelu" else "gate"]["w"]
        return self.tp if w.shape[1] < self.cfg.d_ff else None

    def _split(self, spec):
        """(vocab axis, embed axes) of a table's or head's spec entries
        ``spec`` = (vocabulary entry, model-width entry)."""
        return self._model(spec[0]), shd.live_axes(self.mesh, spec[1])

    def _rows(self, x: torch.Tensor, whole: bool) -> torch.Tensor:
        """Every rank's rows of ``x`` (``whole``), or this rank's block of
        all of them, where the batch is sharded (else ``x``)."""
        if self.batch is None:
            return x
        spec = shd.P(self.batch, *[None] * (x.ndim - 1))
        return (shd.gather_leaf(x, spec, self.mesh) if whole
                else shd.shard_leaf(x, spec, self.mesh))

    def embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """The lookup in this rank's block of the table: every rank's
        tokens in its vocabulary block (others' read zeros, psummed over
        ``model``), its width block all-gathered (FSDP's ``data``), then
        this rank's rows."""
        vocab, width = self._split(self.place.specs["embed"]["table"])
        e = vocab_embed(params["embed"]["table"], self._rows(tokens, True),
                        vocab)
        for ax in reversed(width):
            e = col.all_gather(e, ax, e.ndim - 1, tiled=True)
        return scale_embedding(self._rows(e, False), self.cfg)

    def head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """The final norm, then the head on this rank's block of the
        table (or ``lm_head``): every rank's rows on its width block,
        contracted and psummed over ``data``, then this rank's rows; the
        logits of its vocabulary block all-gathered over ``model``."""
        specs = self.place.specs
        norm = self.gather({"n": params["final_norm"]},
                           {"n": specs["final_norm"]}, None)["n"]
        x = _apply_norm(self.cfg, norm, x)
        # (d, vocab): the head's weight and its spec in that order
        spec = head_weight(specs, self.cfg)
        vocab, width = self._split((spec[1], spec[0]))
        if width:          # every rank's rows, on this rank's width block
            x = shd.shard_leaf(self._rows(x, True),
                               shd.P(None, None, spec[0]), self.mesh)
        logits = vocab_logits(x, head_weight(params, self.cfg))
        if width:
            logits = self._rows(col.psum(logits, width), False)
        return vocab_gather(logits, vocab)


def _attn_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor, caches: List,
              ci: int, window: int, attend, ms) -> torch.Tensor:
    """A dense or moe block's decode: attention through ``attend`` on
    cache ``ci`` (updated in ``caches``), then the MLP, or the MoE where
    the block has one."""
    a, caches[ci] = attend(p["attn"], _apply_norm(cfg, p["ln1"], x),
                           caches[ci], window, ci)
    x = x + a
    h = _apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        return x + apply_moe(p["moe"], h, moe_config(cfg),
                             mesh=None if ms is None else ms.mesh)
    return x + _apply_mlp(cfg, p["mlp"], h,
                          tp_axis=None if ms is None else ms.mlp_axis(
                              p["mlp"]))


def _decode_layers(params: Dict, caches: List, x: torch.Tensor,
                   cfg: ModelConfig, attend,
                   ms: Optional[_OnMesh] = None) -> Tuple[torch.Tensor, List]:
    """The layers of one decode step, ``attend(p, h, cache, window, ci)``
    giving an attention layer's output and its updated cache ``ci``.  SSM
    layers carry no position: they advance one step per call, whatever
    ``pos`` their attention layers see.  The hybrid's shared block writes
    cache ``n_layers + g`` after group ``g``, unwindowed.  An moe model's
    first ``first_dense_layers`` layers come from ``dense_layers``.  An
    encdec decoder layer attends to itself, then to its cache's ``ck`` /
    ``cv`` under an all-ones mask, then runs its MLP.  ``ms``: the step
    runs on a mesh."""
    new = list(caches)

    def layer(key, li, ci):
        if ms is None:
            return _layer_params(params[key], li)
        return ms.layer(params, key, li, ci)

    if cfg.family == "encdec":
        for li in range(cfg.dec_layers):
            p = layer("dec_layers", li, li)
            a, new[li] = attend(p["attn"], _apply_norm(cfg, p["ln1"], x),
                                caches[li], NO_WINDOW, li)
            x = x + a
            x = x + _cross_decode(cfg, p["cross"],
                                  _apply_norm(cfg, p["ln_x"], x), caches[li],
                                  _WHOLE if ms is None else
                                  ms.lays[li]["ck"])
            x = x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x),
                               tp_axis=None if ms is None else
                               ms.mlp_axis(p["mlp"]))
        return x, new
    if cfg.family in ("dense", "moe"):
        head = cfg.first_dense_layers if cfg.family == "moe" else 0
        for li, win in enumerate(window_schedule(cfg)):
            p = (layer("dense_layers", li, li) if li < head
                 else layer("layers", li - head, li))
            x = _attn_mlp(cfg, p, x, new, li, int(win), attend, ms)
        return x, new
    scfg = ssm_config(cfg)
    shared = params.get("shared_block")
    if shared is not None and ms is not None:
        shared = ms.gather(shared, ms.place.specs["shared_block"],
                           cfg.n_layers)
    for li in range(cfg.n_layers):
        p = layer("layers", li, None)
        y, new[li] = apply_ssm_decode(p["ssm"], _apply_norm(cfg, p["ln1"], x),
                                      caches[li], scfg,
                                      **({} if ms is None else ms.ssm(li)))
        x = x + y
        if cfg.family == "hybrid" and (li + 1) % cfg.shared_attn_every == 0:
            x = _attn_mlp(cfg, shared, x, new,
                          cfg.n_layers + li // cfg.shared_attn_every,
                          NO_WINDOW, attend, ms)
    return x, new


def _on_mesh(cfg, mesh, caches, specs) -> Optional[_OnMesh]:
    return None if mesh is None else _OnMesh(cfg, mesh, caches, specs)


def _ends(ms: Optional[_OnMesh], params: Dict, cfg: ModelConfig):
    """(embedding, head) of a step, on the mesh or not."""
    if ms is None:
        return (lambda t: embed_forward(params, t, cfg),
                lambda x: head_forward(params, x, cfg))
    return (lambda t: ms.embed(params, t), lambda x: ms.head(params, x))


def decode_step(params: Dict, caches: List, token, pos,
                cfg: ModelConfig, mesh=None,
                specs=None) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int -> logits (B, vocab) f32; updates caches.

    ``pos`` is an int (all rows decode the same position — the static
    generate path) or a ``(B,)`` int tensor of per-row positions (the
    continuous-batching ragged path; each row reads/writes its own cache
    position).  ``mesh``: run by every rank, on this rank's blocks, the
    caches' placed by ``specs`` (see the module docstring); the logits
    are those of this rank's rows, whole on every rank."""
    device = _device(params)
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        pos = pos.to(device)
    ms = _on_mesh(cfg, mesh, caches, specs)
    embed, head = _ends(ms, params, cfg)
    x = embed(_as_tokens(token, device))

    def attend(p, h, cache, window, ci):
        if cfg.mla:
            lay = _WHOLE if ms is None else ms.lays[ci]["c_kv"]
            return apply_mla_decode(p, h, cache, pos, mla_config(cfg),
                                    lay.seq, lay.lo)
        return _attn_decode(cfg, p, h, cache, pos, window,
                            _WHOLE if ms is None else ms.lays[ci]["k"])

    x, new_caches = _decode_layers(params, caches, x, cfg, attend, ms)
    return head(x)[:, 0], new_caches


def paged_decode_step(params: Dict, caches: List, block_table, token, pos,
                      write_mask, cfg: ModelConfig, max_seq: int, mesh=None,
                      specs=None) -> Tuple[torch.Tensor, List]:
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
    card; the engine hands it over from the host).  ``mesh``/``specs``
    as for :func:`decode_step`: pages hold this rank's KV heads where
    ``model`` divides them (MLA's latent pages are whole)."""
    _paged_family(cfg)
    device = _device(params)
    block_table = torch.as_tensor(block_table, device=device)
    pos = torch.as_tensor(pos, device=device)
    rows = torch.nonzero(torch.as_tensor(write_mask).cpu()).squeeze(1)
    write_rows = None if len(rows) == len(pos) else rows.to(device)
    ms = _on_mesh(cfg, mesh, caches, specs)
    embed, head = _ends(ms, params, cfg)
    x = embed(_as_tokens(token, device))

    def attend(p, h, cache, window, ci):
        if cfg.mla:
            return apply_mla_paged_decode(p, h, cache, block_table, pos,
                                          mla_config(cfg), width=max_seq,
                                          write_rows=write_rows)
        return _attn_decode_paged(cfg, p, h, cache, block_table, pos,
                                  window, max_seq, write_rows,
                                  None if ms is None else
                                  ms.lays[ci]["k"].heads)

    x, new_caches = _decode_layers(params, caches, x, cfg, attend, ms)
    return head(x)[:, 0], new_caches
