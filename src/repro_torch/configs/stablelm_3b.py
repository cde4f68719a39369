"""stablelm-3b [dense] — 32L, d_model=2560, 32 heads (MHA), d_ff=6912,
vocab=50304.  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab=50304,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention"},
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, attn_chunk=32, dtype="float32", remat=False)
