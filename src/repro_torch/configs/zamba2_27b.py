"""zamba2-2.7b [hybrid] — Mamba2 backbone with a shared attention block
(arXiv:2411.15242).  54 Mamba2 layers (d_model=2560, ssm_state=64) with one
shared attention+MLP block (32 heads, d_ff=10240) applied every 6 layers.
long_500k RUNS: SSM state is O(1); the shared attention block's cache is
small (9 applications) and per-step attention is linear."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_p=64,
    ssm_groups=2,
    shared_attn_every=6,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, ssm_state=16, ssm_head_p=16, ssm_groups=1,
    shared_attn_every=2, attn_chunk=32, dtype="float32", remat=False)
