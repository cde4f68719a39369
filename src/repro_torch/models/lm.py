"""Decoder LM assembly, dense (GQA, sliding-window), moe (MoE, with MLA
or GQA attention), ssm and hybrid families: parameter specs,
initialisation, the per-layer window schedule, the embedding and head,
and the full-sequence forward of training and prefill (decode passes run
their layers in :mod:`repro_torch.serve.decode`).

The encoder-decoder family (whisper) is built by
:mod:`repro_torch.models.encdec` from this module's pieces; this
module's ``model_spec`` and ``forward`` refuse it, as the reference's
do.

``tp_axis`` (explicit tensor parallelism inside the pipeline step, a
bound :class:`repro_torch.dist.collectives.Axis`) runs the attention and
MLP on this rank's head / column shards and psums their partial
projections; :func:`stage_forward` applies one pipeline stage's layers.

``mesh`` (the GSPMD step, a :class:`repro_torch.launch.mesh.Mesh` whose
every rank runs :func:`forward`): ``params`` holds this rank's blocks by
``dist.sharding.param_shardings`` and ``tokens`` its batch block.  Each
layer's parameters are all-gathered before use, inside the layer's
remat unit (FSDP over ``data``; the gather's backward reduce-scatters
the gradient to the block), over ``model`` too except where a block
computes on its ``model`` shard: the GQA attention's heads and the
MLP's columns (their row-parallel outputs psum) and the experts
(dispatched by all-to-all, :func:`repro_torch.nn.moe.apply_moe_ep`).
The blocks with no such body compute replicated over ``model``: the SSM
layers, the hybrid's Mamba-2 layers, MLA, the moe family's shared
experts, and the encoder-decoder's layers.  The embedding and the head
are vocabulary-parallel where ``model`` divides the vocabulary
(:func:`vocab_axis`): the table (or ``lm_head``) is gathered over its
FSDP axes only, the lookup psums over ``model`` (:func:`vocab_embed`)
and each rank computes the logits of its block of the vocabulary, which
the GSPMD step's loss takes as they are
(``train.step.cross_entropy``) and :func:`forward` all-gathers.
``cfg.seq_parallel`` keeps the dense and moe residual stream sharded on
the sequence over ``model`` between blocks (Megatron-SP: all-gathered
at a sublayer's entry, reduce-scattered after its row-parallel output;
the same numbers as without it); with no ``model`` axis, or none at
all, it changes nothing, as the reference's ``_sp_constraint``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul, wide
from repro_torch.nn.attention import NO_WINDOW
from repro_torch.nn.core import init_params, stack_specs, torch_dtype
from repro_torch.nn.mla import MLAConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.ssm import SSMConfig
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves, tree_map


def decoder_only(cfg: ModelConfig, what: str) -> None:
    """Raise ``ValueError`` for the encoder-decoder family, which
    :mod:`repro_torch.models.encdec` builds and runs."""
    if cfg.family == "encdec":
        raise ValueError(f"{what}: {cfg.name} is an encoder-decoder; its "
                         f"model is repro_torch.models.encdec")


def mla_config(cfg: ModelConfig) -> MLAConfig:
    return MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                     kv_lora_rank=cfg.kv_lora_rank,
                     qk_nope_dim=cfg.qk_nope_dim,
                     qk_rope_dim=cfg.qk_rope_dim,
                     v_head_dim=cfg.v_head_dim,
                     rope_theta=cfg.rope_theta)


def moe_config(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
                     n_shared=cfg.n_shared_experts,
                     shared_d_ff=cfg.n_shared_experts * cfg.moe_d_ff,
                     capacity_factor=cfg.capacity_factor)


def ssm_config(cfg: ModelConfig) -> SSMConfig:
    return SSMConfig(d_model=cfg.d_model, d_inner=cfg.d_inner,
                     n_heads=cfg.ssm_heads, head_p=cfg.ssm_head_p,
                     n_groups=cfg.ssm_groups, d_state=cfg.ssm_state)


def _norm_spec(cfg: ModelConfig, d: int) -> Dict:
    return (nn.layernorm_spec(d) if cfg.norm == "layernorm"
            else nn.rmsnorm_spec(d))


def _apply_norm(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return (nn.apply_layernorm(p, x) if cfg.norm == "layernorm"
            else nn.apply_rmsnorm(p, x))


def _mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    return (nn.gelu_mlp_spec(cfg.d_model, d_ff) if cfg.mlp == "gelu"
            else nn.swiglu_spec(cfg.d_model, d_ff))


def _apply_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               tp_axis=None, sp: bool = False) -> torch.Tensor:
    return (nn.apply_gelu_mlp(p, x, tp_axis=tp_axis, sp=sp)
            if cfg.mlp == "gelu"
            else nn.apply_swiglu(p, x, tp_axis=tp_axis, sp=sp))


def attn_spec(cfg: ModelConfig) -> Dict:
    if cfg.mla:
        return nn.mla_spec(mla_config(cfg))
    spec = nn.gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.qkv_bias)
    if cfg.qk_norm:
        spec["q_norm"] = nn.rmsnorm_spec(cfg.head_dim, None)
        spec["k_norm"] = nn.rmsnorm_spec(cfg.head_dim, None)
    return spec


def dense_block_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": _norm_spec(cfg, cfg.d_model),
            "attn": attn_spec(cfg),
            "ln2": _norm_spec(cfg, cfg.d_model),
            "mlp": _mlp_spec(cfg)}


def moe_block_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": _norm_spec(cfg, cfg.d_model),
            "attn": attn_spec(cfg),
            "ln2": _norm_spec(cfg, cfg.d_model),
            "moe": nn.moe_spec(moe_config(cfg))}


def ssm_block_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": _norm_spec(cfg, cfg.d_model),
            "ssm": nn.ssm_spec(ssm_config(cfg))}


def model_spec(cfg: ModelConfig) -> Dict:
    decoder_only(cfg, "model_spec")
    spec: Dict = {"embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
                  "final_norm": _norm_spec(cfg, cfg.d_model)}
    if cfg.family == "dense":
        spec["layers"] = stack_specs(dense_block_spec(cfg), cfg.n_layers)
    elif cfg.family == "moe":      # deepseek: leading dense layers first
        if cfg.first_dense_layers:
            spec["dense_layers"] = stack_specs(dense_block_spec(cfg),
                                               cfg.first_dense_layers)
        spec["layers"] = stack_specs(moe_block_spec(cfg),
                                     cfg.n_layers - cfg.first_dense_layers)
    else:
        spec["layers"] = stack_specs(ssm_block_spec(cfg), cfg.n_layers)
    if cfg.family == "hybrid":     # zamba2: one unstacked shared block
        spec["shared_block"] = dense_block_spec(cfg)
    if not cfg.tie_embeddings:
        spec["lm_head"] = nn.lm_head_spec(cfg.d_model, cfg.vocab)
    return spec


def init_model(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Seeded random parameters in ``cfg.dtype`` on the generator's
    device (the same distributions as the reference, other numbers)."""
    return init_params(model_spec(cfg), generator, dtype=cfg.dtype)


def window_schedule(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (NO_WINDOW = global).  Gemma-style: every
    ``global_every``-th layer (1-indexed) is global, the rest local."""
    if cfg.window is None:
        return np.full((cfg.n_layers,), NO_WINDOW, np.int32)
    idx = np.arange(cfg.n_layers)
    is_global = (idx % cfg.global_every) == (cfg.global_every - 1) \
        if cfg.global_every else np.zeros((cfg.n_layers,), bool)
    return np.where(is_global, NO_WINDOW, cfg.window).astype(np.int32)


def head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """The head's weight, (d_model, vocabulary): the tied table's
    transpose (a view), or ``lm_head``'s ``out.w``.  From a spec tree,
    the weight's :class:`repro_torch.dist.sharding.P` in that order."""
    if cfg.tie_embeddings:
        w = params["embed"]["table"]
        return shd.P(w[1], w[0]) if isinstance(w, shd.P) else w.T
    return params["lm_head"]["out"]["w"]


def vocab_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x @ w`` of a (d_model, vocabulary) head weight or of
    a block of its columns, as ``nn.unembed`` and ``nn.apply_lm_head``
    compute them (the same bits: ``w.to`` keeps the transposed table's
    layout)."""
    xf = wide(x)
    return matmul(xf, w.to(xf.dtype))


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab=None) -> torch.Tensor:
    """The rows of ``tokens`` in the embedding table.  With ``vocab`` (a
    bound axis of the mesh), ``table`` is this rank's block of the rows
    split over it in coordinate order: each rank looks up the tokens its
    block holds, reads zeros for the others, and the rows are psummed
    over ``vocab``.  The psum's backward psums the cotangent, so each
    block's gradient is its rows' whole gradient."""
    if vocab is None:
        return table[tokens]
    n = table.shape[0]
    t = tokens - vocab.index * n
    hit = ((t >= 0) & (t < n)).to(table.dtype)
    return col.psum(table[t.clamp(0, n - 1)] * hit[..., None], vocab)


def vocab_gather(logits: torch.Tensor, vocab=None) -> torch.Tensor:
    """Whole-vocabulary logits from each rank's block of the columns
    (``vocab``: the axis they are split over, or None: whole already)."""
    if vocab is None:
        return logits
    return col.all_gather(logits, vocab, logits.ndim - 1, tiled=True)


def vocab_axis(cfg: ModelConfig, mesh):
    """The bound axis over which ``param_shardings`` splits the
    vocabulary (the embedding table's rows, ``lm_head``'s columns) on
    ``mesh``: ``model`` where it is there and divides ``cfg.vocab``,
    else None (no mesh, or the rules' divisibility fallback, which
    keeps the vocabulary whole)."""
    if mesh is None:
        return None
    spec = shd.logical_specs(nn.embedding_spec(cfg.vocab, cfg.d_model),
                             mesh)["table"]
    return (mesh.axis("model") if shd.model_size(mesh) > 1
            and "model" in shd.entry_axes(spec[0]) else None)


def head_forward(params: Dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Final norm + (tied) unembedding: residual stream -> f32 logits;
    of a block of the vocabulary where ``params`` holds a block of the
    table or ``lm_head``."""
    with spans.span(spans.HEAD):
        x = _apply_norm(cfg, params["final_norm"], x)
        return vocab_logits(x, head_weight(params, cfg))


def embed_forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                  vocab=None) -> torch.Tensor:
    """Token embedding (with the gemma sqrt(d) scale) -> residual stream;
    ``vocab``: the table is this rank's block over it
    (:func:`vocab_embed`)."""
    with spans.span(spans.EMBED):
        return scale_embedding(vocab_embed(params["embed"]["table"], tokens,
                                           vocab), cfg)


def scale_embedding(e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Looked-up embeddings -> residual stream (``cfg.dtype``, and the
    gemma sqrt(d) scale)."""
    x = e.to(torch_dtype(cfg.dtype))
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)   # gemma embeds are sqrt(d)-scaled
    return x


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def apply_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
               window: int = NO_WINDOW, q_offset: int = 0,
               causal: bool = True, tp_axis=None,
               sp: bool = False) -> torch.Tensor:
    """Self-attention over the whole sequence: projections, optional
    qk-norm, rope at ``q_offset + arange(S)``, ``chunked_attention``; or
    MLA (:func:`repro_torch.nn.apply_mla`).  Under ``tp_axis`` the
    projection weights are head shards, so the local head counts come
    from the shard shapes (a single KV head stays whole) and the output
    projection psums the partials (``sp``: reduce-scatters them over the
    sequence)."""
    with spans.span(spans.ATTN):
        if cfg.mla:
            return nn.apply_mla(p, x, mla_config(cfg), causal=causal,
                                q_offset=q_offset, chunk=cfg.attn_chunk)
        S = x.shape[1]
        if tp_axis is None:
            n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
        else:
            n_heads = p["wq"]["w"].shape[1] // cfg.head_dim
            n_kv = p["wk"]["w"].shape[1] // cfg.head_dim
        q, k, v = nn.qkv_project(p, x, n_heads, n_kv, cfg.head_dim)
        if cfg.qk_norm:
            q = nn.apply_rmsnorm(p["q_norm"], q)
            k = nn.apply_rmsnorm(p["k_norm"], k)
        positions = (q_offset + torch.arange(S, device=x.device))[None, :]
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
        o = nn.chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk, q_offset=q_offset)
        return nn.out_project(p, o, tp_axis=tp_axis, sp=sp)


def _sublayer_in(cfg: ModelConfig, norm_p: Dict, x: torch.Tensor, tp_axis,
                 sp: bool) -> torch.Tensor:
    """The normed input of a sublayer: under sequence parallelism the
    norm runs on this rank's block and the result is all-gathered."""
    h = _apply_norm(cfg, norm_p, x)
    return col.all_gather(h, tp_axis, 1, tiled=True) if sp else h


def _attn_sub(cfg: ModelConfig, p: Dict, x: torch.Tensor, window: int,
              tp_axis, sp: bool) -> torch.Tensor:
    h = _sublayer_in(cfg, p["ln1"], x, tp_axis, sp)
    sharded = (tp_axis is not None and not cfg.mla and
               p["attn"]["wq"]["w"].shape[1] < cfg.n_heads * cfg.head_dim)
    y = apply_attn(cfg, p["attn"], h, window=window,
                   tp_axis=tp_axis if sharded else None, sp=sp)
    return col.block_of(y, tp_axis, 1) if sp and not sharded else y


def _mlp_sub(cfg: ModelConfig, p: Dict, x: torch.Tensor, tp_axis,
             sp: bool) -> torch.Tensor:
    h = _sublayer_in(cfg, p["ln2"], x, tp_axis, sp)
    w = p["mlp"]["up" if cfg.mlp == "gelu" else "gate"]["w"]
    sharded = tp_axis is not None and w.shape[1] < cfg.d_ff
    y = _apply_mlp(cfg, p["mlp"], h, tp_axis=tp_axis if sharded else None,
                   sp=sp)
    return col.block_of(y, tp_axis, 1) if sp and not sharded else y


def dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                window: int = NO_WINDOW, mesh=None, tp_axis=None,
                sp: bool = False) -> torch.Tensor:
    """Attention then MLP, each residual.  ``tp_axis``: the sublayers
    whose weights are ``model`` shards compute on them; ``sp``: ``x`` is
    this rank's sequence block, and so is the result."""
    x = x + _attn_sub(cfg, p, x, window, tp_axis, sp)
    return x + _mlp_sub(cfg, p, x, tp_axis, sp)


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              window: int = NO_WINDOW, mesh=None, tp_axis=None,
              sp: bool = False) -> torch.Tensor:
    """Attention then the MoE layer, each residual; with ``mesh`` the
    layer takes the reference's expert-parallel dispatch
    (:func:`repro_torch.nn.apply_moe`)."""
    x = x + _attn_sub(cfg, p, x, window, tp_axis, sp)
    return x + nn.apply_moe(p["moe"], _apply_norm(cfg, p["ln2"], x),
                            moe_config(cfg), mesh=mesh, seq_sharded=sp)


def ssm_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x + nn.apply_ssm(p["ssm"], _apply_norm(cfg, p["ln1"], x),
                            ssm_config(cfg))


def _unstack(stacked: Dict, n: int) -> List[Dict]:
    """The per-layer parameter dicts of a stacked tree, as views.  One
    ``unbind`` per leaf: its backward stacks the layers' gradients into
    the stacked leaf's gradient once, where indexing layer by layer would
    add a zero-filled full-size gradient per layer."""
    out: List[Dict] = [{} for _ in range(n)]
    for key, val in stacked.items():
        parts = (_unstack(val, n) if isinstance(val, dict)
                 else val.unbind(0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective checkpoint's policy under ``remat_policy="dots"``:
    save the products (``ops.PRODUCTS``), recompute every other op, an
    allocation such as ``aten.empty`` above all (a kernel writes into the
    tensor it returns)."""
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in ops.PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body, x: torch.Tensor,
           policy: Optional[str] = None) -> torch.Tensor:
    """``body(x)``; with ``cfg.remat`` under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of ``jax.checkpoint`` at ``policy``
    (default ``cfg.remat_policy``).  ``"nothing"``
    (``nothing_saveable``): only ``x`` is kept and ``body`` is recomputed
    in the backward pass.  ``"dots"`` (``dots_saveable``): the outputs of
    the matrix products are kept too, and the recompute takes them
    instead of running the products again (:func:`_dots_saveable`).

    The model kernels launch through ctypes, which no dispatch policy
    sees, so they have a rule of their own.  K2 (``fused_ff``), K6
    (``flash_attention``) and K7 (``ssd``) fuse products that
    ``dots_saveable`` would save: their autograd Functions launch through
    custom operators that ``ops.PRODUCTS`` names, so under ``"dots"``
    their outputs are saved and the recompute does not launch them.  K1
    (``rmsnorm``) is recomputed.  A dense step at L layers thus launches
    K1 4L + 1, K2 L and K6 L times under ``"dots"``, against 4L + 1, 2L
    and 2L under ``"nothing"``.

    The checkpoint's second and later calls of ``body`` (the recompute
    in the backward pass) run under :func:`repro_torch.utils.spans.recompute`."""
    if not cfg.remat:
        return body(x)
    extra = {}
    if (policy or cfg.remat_policy) == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    calls = 0

    def run(h: torch.Tensor) -> torch.Tensor:
        nonlocal calls
        calls += 1
        if calls == 1:
            return body(h)
        with spans.recompute():
            return body(h)

    return torch.utils.checkpoint.checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False, **extra)


class Placement:
    """What :func:`forward` needs of a mesh: the mesh, its parameter
    specs (``param_shardings`` of the model's spec tree), the ``model``
    axis (None when it is absent or of size 1) and whether the residual
    stream is sequence-sharded (``sp``: ``cfg.seq_parallel``, a
    ``model`` axis dividing the sequence, the dense or moe family)."""

    def __init__(self, cfg: ModelConfig, mesh, seq_len: int, spec_tree):
        self.cfg, self.mesh = cfg, mesh
        self.specs = shd.param_shardings(spec_tree, mesh)
        m = shd.model_size(mesh)
        self.tp = mesh.axis("model") if m > 1 else None
        self.sp = bool(cfg.seq_parallel and self.tp is not None
                       and cfg.family in ("dense", "moe")
                       and seq_len % m == 0)
        self.vocab = vocab_axis(cfg, mesh)

    def top(self, params: Dict) -> Dict:
        """The embedding, the final norm and the head (``_TOP_KEYS``) for
        use: gathered over their FSDP axes, each rank keeping its
        vocabulary block over ``model`` (the only ``model`` entry their
        specs can have)."""
        return {k: tree_map(lambda x, s: shd.gather_for_use(
            x, s, self.mesh, ("model",)), params[k], self.specs[k])
            for k in _TOP_KEYS if k in params}

    def _keeps_model(self, path, spec) -> bool:
        """Whether a block computes on this leaf's ``model`` shard: the
        GQA projections when each rank's shard holds whole query heads
        and whole KV heads or there is one KV head, which stays whole (the
        rules split the flattened head dim wherever ``model`` divides
        it); the MLP's columns; experts sharded by expert."""
        cfg, m = self.cfg, shd.model_size(self.mesh)
        if path[0] == "attn":
            kv_split = cfg.n_kv_heads % m == 0
            tp = (not cfg.mla and cfg.n_heads % m == 0
                  and (kv_split or cfg.n_kv_heads == 1))
            return tp and (kv_split or path[1] not in ("wk", "wv"))
        if path[0] == "mlp":
            return True
        return path[:2] == ("moe", "experts") and spec[0] == "model"

    def gather(self, p, specs, tp: bool, path=()):
        """``p`` (this rank's blocks) all-gathered over every axis its
        ``specs`` shard it on, ``model`` excepted where ``tp`` and a block
        computes on the shard."""
        if isinstance(p, dict):
            return {k: self.gather(p[k], specs[k], tp, path + (k,))
                    for k in p}
        keep = ("model",) if tp and self._keeps_model(path, specs) else ()
        return shd.gather_for_use(p, specs, self.mesh, keep)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream after the embedding: this rank's sequence
        block under sequence parallelism."""
        return col.block_of(x, self.tp, 1) if self.sp else x

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream before the head, whole again."""
        return col.all_gather(x, self.tp, 1, tiled=True) if self.sp else x


def _layer_specs(stacked_specs):
    """The spec tree of one layer of a stacked tree (the leading
    ``layers`` entry dropped)."""
    return tree_map(lambda s: shd.P(*tuple(s)[1:]), stacked_specs)


def _scan_layers(cfg: ModelConfig, block, stacked: Dict, x: torch.Tensor,
                 windows: Optional[np.ndarray] = None, tp_axis=None,
                 place: Optional[Placement] = None,
                 key: str = "layers") -> torch.Tensor:
    """The reference's ``lax.scan`` over the stacked layer axis, as a
    Python loop, each layer under :func:`_remat`.  With ``place`` (the
    GSPMD forward), ``stacked`` is ``params[key]``'s blocks and each
    layer gathers its parameters inside its remat unit."""
    n = tree_leaves(stacked)[0].shape[0]
    kw = {}
    if tp_axis is not None:
        kw["tp_axis"] = tp_axis
    tp = block is not ssm_block
    if place is not None:
        specs = _layer_specs(place.specs[key])
        if tp:
            kw.update(mesh=place.mesh, tp_axis=place.tp, sp=place.sp)
    for i, layer_p in enumerate(_unstack(stacked, n)):
        wkw = dict(kw) if windows is None else dict(kw, window=int(windows[i]))
        if place is None:
            body = functools.partial(block, cfg, layer_p, **wkw)
        else:
            def body(h, lp=layer_p, wkw=wkw):
                return block(cfg, place.gather(lp, specs, tp), h, **wkw)
        x = _remat(cfg, body, x)
    return x


_BLOCK_OF = {"dense": dense_block, "moe": moe_block, "ssm": ssm_block}


def stage_forward(cfg: ModelConfig, stacked: Dict, x: torch.Tensor,
                  windows: Optional[np.ndarray] = None,
                  tp_axis=None) -> torch.Tensor:
    """Apply a contiguous sub-stack of decoder blocks — one pipeline stage.

    ``stacked`` holds this stage's layers with a leading layer dim (any
    length that the leaves agree on); ``windows`` is the matching slice of
    :func:`window_schedule` for attention families.  Runs with
    ``mesh=None``: the pipeline step owns all collectives explicitly.
    ``tp_axis`` is the tensor-parallel axis when the stage runs on a
    ``pipe × model`` mesh: the attention/MLP weights are then
    head-/column-shards and the blocks psum their partial projections over
    it (:mod:`repro_torch.nn.layers`, :mod:`repro_torch.nn.attention`).
    """
    block = _BLOCK_OF.get(cfg.family)
    if block is None:
        raise ValueError(f"stage_forward: unsupported family {cfg.family}")
    if cfg.family == "ssm":
        windows = None   # ssm blocks take no attention window
        if tp_axis is not None:
            raise ValueError("stage_forward: ssm blocks have no TP path")
    return _scan_layers(cfg, block, stacked, x, windows=windows,
                        tp_axis=tp_axis)


def _hybrid_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                    place: Optional[Placement] = None) -> torch.Tensor:
    """Zamba2: groups of ``shared_attn_every`` Mamba-2 layers, each group
    followed by the one shared attention + MLP block.  Each group (its
    SSM layers and the shared block) is one :func:`_remat` unit, as the
    reference checkpoints ``group_fn``, recomputing the whole group
    whatever ``remat_policy`` says; the shared block's gradient is the
    sum over its applications.  With ``place`` the shared block is
    gathered once and computes on its ``model`` shards, and each Mamba-2
    layer is gathered whole inside its group."""
    k = cfg.shared_attn_every
    assert cfg.n_layers % k == 0, (cfg.n_layers, k)
    layers = _unstack(params["layers"], cfg.n_layers)
    shared, kw = params["shared_block"], {}
    if place is not None:
        specs = _layer_specs(place.specs["layers"])
        shared = place.gather(shared, place.specs["shared_block"], True)
        kw = {"tp_axis": place.tp}

    def group_fn(group: List[Dict], h: torch.Tensor) -> torch.Tensor:
        for layer_p in group:
            if place is not None:
                layer_p = place.gather(layer_p, specs, False)
            h = ssm_block(cfg, layer_p, h)
        return dense_block(cfg, shared, h, **kw)

    for g in range(0, cfg.n_layers, k):
        x = _remat(cfg, functools.partial(group_fn, layers[g: g + k]), x,
                   "nothing")
    return x


_TOP_KEYS = ("embed", "final_norm", "lm_head")


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            mesh=None, vocab_block: bool = False) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, vocab), dense, moe, ssm and
    hybrid families.  With ``mesh`` (run by every rank; see the module
    docstring) ``params`` holds this rank's blocks and ``tokens`` its
    batch block, and the logits are that block's, on every rank of the
    ``model`` axis; with ``vocab_block`` too, only this rank's block of
    the vocabulary's columns where :func:`vocab_axis` splits it (the
    GSPMD step's loss)."""
    decoder_only(cfg, "forward")
    place = vocab = None
    top = params
    if mesh is not None:
        place = Placement(cfg, mesh, tokens.shape[1], model_spec(cfg))
        top, vocab = place.top(params), place.vocab
    x = embed_forward(top, tokens, cfg, vocab)
    if place is not None:
        x = place.enter(x)
    if cfg.family == "dense":
        x = _scan_layers(cfg, dense_block, params["layers"], x,
                         windows=window_schedule(cfg), place=place)
    elif cfg.family == "moe":
        head = cfg.first_dense_layers
        if head:
            x = _scan_layers(cfg, dense_block, params["dense_layers"], x,
                             windows=window_schedule(cfg)[:head],
                             place=place, key="dense_layers")
        x = _scan_layers(cfg, moe_block, params["layers"], x,
                         windows=window_schedule(cfg)[head:], place=place)
    elif cfg.family == "ssm":
        x = _scan_layers(cfg, ssm_block, params["layers"], x, place=place)
    else:
        x = _hybrid_forward(params, x, cfg, place)
    if place is not None:
        x = place.leave(x)
    logits = head_forward(top, x, cfg)
    return logits if vocab_block else vocab_gather(logits, vocab)
