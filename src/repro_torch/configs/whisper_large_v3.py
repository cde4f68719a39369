"""whisper-large-v3 [audio] — encoder-decoder transformer backbone
(arXiv:2212.04356).  32 enc + 32 dec layers, d_model=1280, 20 heads
(kv=20), d_ff=5120, vocab=51866.  The conv/mel frontend is a STUB per the
brief: input_specs() provides precomputed frame embeddings.  Decode shapes
lower the decoder serve_step with cross-attention over stubbed encoder
states (ENC_LEN_DECODE frames).  long_500k skipped: dense full attention."""

from repro_torch.configs.base import ModelConfig

ENC_LEN_DECODE = 1536  # encoder frames available to the decoder at decode

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=64,
    enc_layers=32,
    dec_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    tie_embeddings=True,
    frontend="audio_frames",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    shape_skips={"long_500k": "dense full attention; 500k KV cache is the "
                              "textbook sub-quadratic-only cell"},
)

REDUCED = CONFIG.replace(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=128, attn_chunk=32,
    dtype="float32", remat=False)
