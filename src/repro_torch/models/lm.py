"""Decoder LM assembly, dense family: parameter specs, initialisation,
the per-layer window schedule, and the embedding and head that frame a
decode pass (:mod:`repro_torch.serve.decode` runs the layers).

The other families of the reference (moe, ssm, hybrid, encdec) raise
``NotImplementedError`` naming their ROADMAP item; the full-sequence
training forward waits for the training slice (ROADMAP D5).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import NO_WINDOW
from repro_torch.nn.core import init_params, stack_specs, torch_dtype

_FAMILY_ITEM = {
    "moe": "ROADMAP D2 (MoE and MLA decode)",
    "ssm": "ROADMAP D3 (SSM decode and the ssd kernel)",
    "hybrid": "ROADMAP D3 (SSM decode and the ssd kernel)",
    "encdec": "ROADMAP D4 (encoder-decoder)",
}


def require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        item = _FAMILY_ITEM.get(cfg.family, "ROADMAP D")
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"see {item}")


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


def _apply_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return (nn.apply_gelu_mlp(p, x) if cfg.mlp == "gelu"
            else nn.apply_swiglu(p, x))


def attn_spec(cfg: ModelConfig) -> Dict:
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


def model_spec(cfg: ModelConfig) -> Dict:
    require_dense(cfg, "model_spec")
    spec: Dict = {"embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
                  "final_norm": _norm_spec(cfg, cfg.d_model),
                  "layers": stack_specs(dense_block_spec(cfg), cfg.n_layers)}
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

