"""Encoder-decoder transformer (whisper-large-v3 backbone).

Port of ``repro/models/encdec.py``.  The audio frontend (mel + conv) is
a stub, as in the reference: the encoder consumes precomputed frame
embeddings (B, S_enc, d_model).  Non-causal encoder self-attention,
causal decoder self-attention, then cross-attention over the encoder's
output; layernorm and the GELU MLP.  Every attention of the forward is
one ``nn.chunked_attention`` call (on the card the hand-written kernel
K6).  Decoding runs in :mod:`repro_torch.serve.decode`, over the
cross caches ``ck``/``cv`` that a caller fills.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.lm import (_apply_mlp, _apply_norm, _mlp_spec,
                                   _norm_spec, _remat, _unstack,
                                   apply_attn, embed_forward, head_forward,
                                   vocab_axis, vocab_gather)
from repro_torch.utils.tree import tree_map
from repro_torch.nn.core import (apply_dense, init_params, stack_specs,
                                 torch_dtype)


def enc_block_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": _norm_spec(cfg, cfg.d_model),
            "attn": nn.gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qkv_bias),
            "ln2": _norm_spec(cfg, cfg.d_model),
            "mlp": _mlp_spec(cfg)}


def dec_block_spec(cfg: ModelConfig) -> Dict:
    spec = enc_block_spec(cfg)
    spec["ln_x"] = _norm_spec(cfg, cfg.d_model)
    spec["cross"] = nn.gqa_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qkv_bias)
    return spec


def model_spec(cfg: ModelConfig) -> Dict:
    return {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model),
        "enc_layers": stack_specs(enc_block_spec(cfg), cfg.enc_layers),
        "enc_norm": _norm_spec(cfg, cfg.d_model),
        "dec_layers": stack_specs(dec_block_spec(cfg), cfg.dec_layers),
        "final_norm": _norm_spec(cfg, cfg.d_model),
    }


def init_model(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Seeded random parameters in ``cfg.dtype`` on the generator's
    device (the same distributions as the reference, other numbers)."""
    return init_params(model_spec(cfg), generator, dtype=cfg.dtype)


def _cross_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
    """q from the decoder stream, k and v from ``enc_out``: the biased
    projections, no rope."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    q = apply_dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = apply_dense(p["wk"], enc_out).reshape(B, Se, cfg.n_kv_heads,
                                              cfg.head_dim)
    v = apply_dense(p["wv"], enc_out).reshape(B, Se, cfg.n_kv_heads,
                                              cfg.head_dim)
    o = nn.chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return nn.out_project(p, o)


def _enc_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    x = x + apply_attn(cfg, p["attn"], _apply_norm(cfg, p["ln1"], x),
                       causal=False)
    return x + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], x))


def _dec_block(cfg: ModelConfig, p: Dict, enc_out: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    h = h + apply_attn(cfg, p["attn"], _apply_norm(cfg, p["ln1"], h))
    h = h + _cross_attn(cfg, p["cross"], _apply_norm(cfg, p["ln_x"], h),
                        enc_out)
    return h + _apply_mlp(cfg, p["mlp"], _apply_norm(cfg, p["ln2"], h))


def encode(params: Dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d_model) stubbed frontend embeddings -> the
    normed encoder states (B, S_enc, d_model) in ``cfg.dtype``.  Each
    layer is one :func:`repro_torch.models.lm._remat` unit, recomputed
    whole whatever ``remat_policy`` says, as the reference's."""
    x = frames.to(torch_dtype(cfg.dtype))
    for layer_p in _unstack(params["enc_layers"], cfg.enc_layers):
        x = _remat(cfg, functools.partial(_enc_block, cfg, layer_p), x,
                   "nothing")
    return _apply_norm(cfg, params["enc_norm"], x)


def decode_train(params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, vocab=None) -> torch.Tensor:
    """tokens (B, S) over ``enc_out`` -> f32 logits (B, S, vocab).  Each
    layer is one remat unit (recomputed whole, as the encoder's) that
    reads ``enc_out`` from its closure: the non-reentrant checkpoint
    recomputes the layer over the same tensor, so ``enc_out``'s gradient
    sums every layer's.  ``vocab``: ``params``' table is this rank's
    block of the vocabulary over that axis, and so are the logits."""
    x = embed_forward(params, tokens, cfg, vocab)
    for layer_p in _unstack(params["dec_layers"], cfg.dec_layers):
        x = _remat(cfg, functools.partial(_dec_block, cfg, layer_p, enc_out),
                   x, "nothing")
    return head_forward(params, x, cfg)


def forward(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, mesh=None,
            vocab_block: bool = False) -> torch.Tensor:
    """frames (B, S_enc, d_model), tokens (B, S) -> f32 logits
    (B, S, vocab).  With ``mesh`` (the GSPMD step, run by every rank)
    ``params`` holds this rank's blocks by ``param_shardings`` and the
    inputs its batch block: the reference only places the parameters,
    and the port all-gathers every leaf before the forward (the gather's
    backward reduce-scatters the gradient to the block) and computes the
    layers replicated over ``model``.  The embedding and the head are
    vocabulary-parallel as :func:`repro_torch.models.lm.forward`'s: the
    table keeps its ``model`` block, and the logits are all-gathered over
    ``model``, or with ``vocab_block`` left as this rank's block."""
    vocab = None
    if mesh is not None:
        specs = shd.param_shardings(model_spec(cfg), mesh)
        params = {k: tree_map(lambda x, s: shd.gather_for_use(
            x, s, mesh, ("model",) if k == "embed" else ()), v, specs[k])
            for k, v in params.items()}
        vocab = vocab_axis(cfg, mesh)
    logits = decode_train(params, tokens, encode(params, frames, cfg), cfg,
                          vocab)
    return logits if vocab_block else vocab_gather(logits, vocab)
