"""qwen1.5-4b [dense] — 40L, d_model=2560, 20 heads (MHA), d_ff=6912,
vocab=151936, QKV bias.  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention"},
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, attn_chunk=32, dtype="float32", remat=False)
