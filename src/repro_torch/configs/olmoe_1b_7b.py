"""olmoe-1b-7b [moe] — fully sparse MoE LM (arXiv:2409.02060).
16L, d_model=2048, 16 heads, 64 experts top-8 (expert d_ff=1024),
vocab=50304.  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    capacity_factor=1.25,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention"},
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, vocab=256, n_experts=8, top_k=2, moe_d_ff=48,
    attn_chunk=32, dtype="float32", remat=False)
