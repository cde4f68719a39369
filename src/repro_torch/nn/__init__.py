"""PyTorch NN substrate: params as nested dicts of tensors + (spec, apply)
function pairs, leaf for leaf the JAX package's layout."""

from repro_torch.nn.attention import (NO_WINDOW, chunked_attention,
                                      decode_attention, decode_positions,
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
from repro_torch.nn.mla import (MLAConfig, apply_mla, apply_mla_decode,
                                apply_mla_paged_decode, init_mla_cache,
                                init_paged_mla_cache, mla_spec)
from repro_torch.nn.moe import (MoEConfig, apply_moe, apply_moe_dense,
                                apply_moe_ep, apply_moe_ep_replicated,
                                moe_spec, router_probs)
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.ssm import (SSMConfig, apply_ssm, apply_ssm_decode,
                                init_ssm_cache, ssm_spec)

__all__ = ["MLAConfig", "MoEConfig", "NO_WINDOW", "ParamSpec", "SSMConfig",
           "apply_dense", "apply_embedding", "apply_gelu_mlp",
           "apply_layernorm", "apply_lm_head", "apply_mla",
           "apply_moe_ep", "apply_moe_ep_replicated",
           "apply_mla_decode", "apply_mla_paged_decode", "apply_moe",
           "apply_moe_dense", "apply_rmsnorm", "apply_rope", "apply_ssm",
           "apply_ssm_decode", "apply_swiglu", "chunked_attention",
           "decode_attention", "decode_positions", "dense", "embedding_spec",
           "gather_page_window", "gather_pages", "gelu_mlp_spec", "gqa_spec",
           "init_mla_cache", "init_paged_mla_cache", "init_params",
           "init_ssm_cache", "layernorm_spec", "lm_head_spec",
           "masked_decode_attention", "mla_spec", "moe_spec", "out_project",
           "paged_decode_attention", "paged_flat_index", "paged_update_cache",
           "qkv_project", "rmsnorm_spec", "router_probs", "ssm_spec",
           "stack_specs", "swiglu_spec", "torch_dtype", "unembed",
           "update_cache"]
