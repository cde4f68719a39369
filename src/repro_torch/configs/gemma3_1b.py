"""gemma3-1b [dense] — 26L, d_model=1152, 4 heads GQA kv=1, d_ff=6912,
vocab=262144, 5:1 local:global sliding-window attention (window=512, every
6th layer global), 128k+ context.  long_500k RUNS: 25/30 of layers have a
bounded 512-token cache; the kv=1 global layers hold the long cache,
sharded by sequence over the model axis."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    window=512,
    global_every=6,           # layers 5, 11, 17, 23 are global
    rope_theta=1_000_000.0,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

REDUCED = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256, window=8, global_every=3, attn_chunk=32,
    dtype="float32", remat=False)
