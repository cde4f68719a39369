"""mamba2-1.3b [ssm] — attention-free SSD LM (arXiv:2405.21060).
48L, d_model=2048 (d_inner=4096, 64 heads of P=64), ssm_state=128,
vocab=50280.  long_500k RUNS: O(1) recurrent state per layer."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,          # attention-free; SSD heads derived below
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,             # no MLP: pure Mamba2 stack
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_p=64,
    ssm_groups=1,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_p=16,
    dtype="float32", remat=False)
