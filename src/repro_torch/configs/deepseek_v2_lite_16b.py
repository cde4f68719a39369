"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE (arXiv:2405.04434).
27L, d_model=2048, 16 heads, MLA kv_lora_rank=512, MoE 64 routed top-6 + 2
shared experts (expert d_ff=1408), first layer dense (d_ff=10944),
vocab=102400.  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,          # v_head_dim; qk dims below
    d_ff=10944,            # the leading dense layer
    vocab=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention (MLA compresses the "
                              "cache but per-step attention is still over "
                              "the full 500k latent sequence)"},
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=256, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=48,
    first_dense_layers=1, attn_chunk=32, dtype="float32", remat=False)
