"""chameleon-34b [vlm] — early-fusion token-based VLM backbone
(arXiv:2405.09818).  48L, d_model=8192, 64 heads GQA kv=8, d_ff=22016,
unified vocab=65536 (text + VQ image tokens), qk-norm.  The VQ image
tokenizer frontend is a STUB per the brief: input_specs() provides token
ids drawn from the unified vocabulary.  long_500k skipped: dense full
attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    frontend="vq_tokens",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention"},
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, attn_chunk=32, dtype="float32", remat=False)
