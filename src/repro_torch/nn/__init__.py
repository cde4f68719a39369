"""PyTorch NN substrate: params as nested dicts of tensors + (spec, apply)
function pairs, leaf for leaf the JAX package's layout."""

from repro_torch.nn.attention import (NO_WINDOW, decode_attention,
                                      gather_page_window, gather_pages,
                                      gqa_spec, masked_decode_attention,
                                      out_project, paged_decode_attention,
                                      paged_flat_index, paged_update_cache,
                                      qkv_project, update_cache)
from repro_torch.nn.core import (ParamSpec, apply_dense, dense, init_params,
                                 stack_specs, torch_dtype)
from repro_torch.nn.layers import (apply_embedding, apply_gelu_mlp,
                                   apply_layernorm, apply_lm_head,
                                   apply_rmsnorm, apply_swiglu,
                                   embedding_spec, gelu_mlp_spec,
                                   layernorm_spec, lm_head_spec, rmsnorm_spec,
                                   swiglu_spec, unembed)
from repro_torch.nn.rope import apply_rope

__all__ = ["NO_WINDOW", "ParamSpec", "apply_dense", "apply_embedding",
           "apply_gelu_mlp", "apply_layernorm", "apply_lm_head",
           "apply_rmsnorm", "apply_rope", "apply_swiglu", "decode_attention",
           "dense", "embedding_spec", "gather_page_window", "gather_pages",
           "gelu_mlp_spec", "gqa_spec", "init_params", "layernorm_spec",
           "lm_head_spec", "masked_decode_attention",
           "out_project", "paged_decode_attention", "paged_flat_index",
           "paged_update_cache", "qkv_project", "rmsnorm_spec",
           "stack_specs", "swiglu_spec", "torch_dtype", "unembed",
           "update_cache"]
