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
The GSPMD hooks (``mesh``, ``seq_parallel``) raise
``NotImplementedError`` naming ROADMAP A14b.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import NO_WINDOW
from repro_torch.nn.core import init_params, stack_specs, torch_dtype
from repro_torch.nn.mla import MLAConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.ssm import SSMConfig
from repro_torch.utils.tree import tree_leaves

_DIST_ITEM = "ROADMAP A14b (the GSPMD path)"


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
                     shared_d_ff=cfg.n_shared_experts * cfg.moe_d_ff)


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
               tp_axis=None) -> torch.Tensor:
    return (nn.apply_gelu_mlp(p, x, tp_axis=tp_axis) if cfg.mlp == "gelu"
            else nn.apply_swiglu(p, x, tp_axis=tp_axis))


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


def head_forward(params: Dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Final norm + (tied) unembedding: residual stream -> f32 logits."""
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return nn.unembed(params["embed"], x)
    return nn.apply_lm_head(params["lm_head"], x)


def embed_forward(params: Dict, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Token embedding (with the gemma sqrt(d) scale) -> residual stream."""
    x = nn.apply_embedding(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)   # gemma embeds are sqrt(d)-scaled
    return x


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def _no_dist(what: str, mesh=None) -> None:
    if mesh is not None:
        raise NotImplementedError(f"{what}: a mesh (the GSPMD path) is not "
                                  f"ported yet; see {_DIST_ITEM}")


def apply_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
               window: int = NO_WINDOW, q_offset: int = 0,
               causal: bool = True, tp_axis=None) -> torch.Tensor:
    """Self-attention over the whole sequence: projections, optional
    qk-norm, rope at ``q_offset + arange(S)``, ``chunked_attention``; or
    MLA (:func:`repro_torch.nn.apply_mla`).  Under ``tp_axis`` the
    projection weights are head shards, so the local head counts come
    from the shard shapes and the output projection psums the
    partials."""
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
    return nn.out_project(p, o, tp_axis=tp_axis)


def dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                window: int = NO_WINDOW, mesh=None,
                tp_axis=None) -> torch.Tensor:
    _no_dist("dense_block", mesh)
    x = x + apply_attn(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x),
                       window=window, tp_axis=tp_axis)
    x = x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x),
                       tp_axis=tp_axis)
    return x


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              window: int = NO_WINDOW, mesh=None,
              tp_axis=None) -> torch.Tensor:
    _no_dist("moe_block", mesh)
    x = x + apply_attn(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x),
                       window=window, tp_axis=tp_axis)
    x = x + nn.apply_moe(p["moe"], _apply_norm(cfg, p["ln2"], x),
                         moe_config(cfg))
    return x


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


def _remat(cfg: ModelConfig, body, x: torch.Tensor) -> torch.Tensor:
    """``body(x)``; with ``cfg.remat`` under ``torch.utils.checkpoint``
    (non-reentrant): only ``x`` is kept and ``body`` is recomputed in the
    backward pass, the counterpart of
    ``jax.checkpoint(policy=nothing_saveable)``."""
    if cfg.seq_parallel:
        raise NotImplementedError(f"seq_parallel ({cfg.name}) needs a mesh; "
                                  f"see {_DIST_ITEM}")
    if not cfg.remat:
        return body(x)
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: only 'nothing' (recompute "
            f"the whole layer) is ported")
    return torch.utils.checkpoint.checkpoint(
        body, x, use_reentrant=False, preserve_rng_state=False)


def _scan_layers(cfg: ModelConfig, block, stacked: Dict, x: torch.Tensor,
                 windows: Optional[np.ndarray] = None, mesh=None,
                 tp_axis=None) -> torch.Tensor:
    """The reference's ``lax.scan`` over the stacked layer axis, as a
    Python loop, each layer under :func:`_remat`."""
    _no_dist("_scan_layers", mesh)
    n = tree_leaves(stacked)[0].shape[0]
    for i, layer_p in enumerate(_unstack(stacked, n)):
        kw = {} if windows is None else {"window": int(windows[i])}
        if tp_axis is not None:
            kw["tp_axis"] = tp_axis
        x = _remat(cfg, functools.partial(block, cfg, layer_p, **kw), x)
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


def _hybrid_forward(params: Dict, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Zamba2: groups of ``shared_attn_every`` Mamba-2 layers, each group
    followed by the one shared attention + MLP block.  Each group (its
    SSM layers and the shared block) is one :func:`_remat` unit, as the
    reference checkpoints ``group_fn``; the shared block's gradient is
    the sum over its applications."""
    k = cfg.shared_attn_every
    assert cfg.n_layers % k == 0, (cfg.n_layers, k)
    layers = _unstack(params["layers"], cfg.n_layers)
    shared = params["shared_block"]

    def group_fn(group: List[Dict], h: torch.Tensor) -> torch.Tensor:
        for layer_p in group:
            h = ssm_block(cfg, layer_p, h)
        return dense_block(cfg, shared, h)

    for g in range(0, cfg.n_layers, k):
        x = _remat(cfg, functools.partial(group_fn, layers[g: g + k]), x)
    return x


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, vocab), dense, moe, ssm and
    hybrid families."""
    decoder_only(cfg, "forward")
    _no_dist("forward", mesh)
    x = embed_forward(params, tokens, cfg)
    if cfg.family == "dense":
        x = _scan_layers(cfg, dense_block, params["layers"], x,
                         windows=window_schedule(cfg))
    elif cfg.family == "moe":
        head = cfg.first_dense_layers
        if head:
            x = _scan_layers(cfg, dense_block, params["dense_layers"], x,
                             windows=window_schedule(cfg)[:head])
        x = _scan_layers(cfg, moe_block, params["layers"], x,
                         windows=window_schedule(cfg)[head:])
    elif cfg.family == "ssm":
        x = _scan_layers(cfg, ssm_block, params["layers"], x)
    else:
        x = _hybrid_forward(params, x, cfg)
    return head_forward(params, x, cfg)
