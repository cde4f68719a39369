"""stablelm-12b [dense] — 40L, d_model=5120, 32 heads GQA kv=8,
d_ff=13824, vocab=100352.  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention"},
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, attn_chunk=32, dtype="float32", remat=False)
