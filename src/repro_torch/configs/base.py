"""Model / shape configuration schema for the assigned architectures.

Every architecture file instantiates one :class:`ModelConfig` with its
published numbers plus a ``reduced()`` smoke variant (same family, tiny
dims) that runs a real decode step on CPU.  The full configs run on the
card (``chip_smoke.py`` serves qwen1.5-4b at full width).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# The four assigned input shapes (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None       # sliding-window size for local layers
    global_every: int = 0              # every Nth layer is global (gemma 5:1 -> 6)

    # norm / mlp flavour
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    mlp: str = "swiglu"                # swiglu | gelu
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    first_dense_layers: int = 0        # DeepSeek: leading dense FFN layers
    capacity_factor: float = 1.25

    # MLA (DeepSeek)
    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_p: int = 64
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stub: None | "audio_frames" | "vq_tokens"
    frontend: Optional[str] = None

    # execution
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    train_microbatches: int = 1     # gradient-accumulation chunks
    attn_chunk: int = 2048
    seq_parallel: bool = False   # constrain inter-block activations to be
                                 # sequence-sharded over the model axis (SP)

    # distributed train step (train.step.make_sharded_train_step):
    # pipeline_stages > 1 opts the config into the shard_map pipeline step —
    # launchers size the mesh's `pipe` axis from it; pipeline_microbatches
    # is the microbatch stream M (bubble fraction (S-1)/(M+S-1));
    # pipeline_schedule picks the micro-op timetable (dist.pipeline
    # SCHEDULES): "gpipe" holds all M microbatch activations live per
    # stage, "1f1b" bounds them at min(S, M) in the schedule's accounting
    # model (what a runtime that retires activations at each backward
    # micro-op realizes — see dist.pipeline); compress_pod_grads routes
    # the multi-pod gradient reduction through
    # dist.compress.compressed_psum (bf16 wire format + error feedback)
    # instead of a plain fp32 psum, and overlap_pod_reduce issues it
    # per gradient group as the stage grads finalize during the backward
    # drain (joined at the optimizer update) instead of monolithically.
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4
    pipeline_schedule: str = "gpipe"
    compress_pod_grads: bool = True
    overlap_pod_reduce: bool = True
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k",
                                         "decode_32k")
    shape_skips: Dict[str, str] = dataclasses.field(default_factory=dict)

    # ---- derived -----------------------------------------------------------

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_p

    def n_params(self) -> int:
        """Total parameter estimate (for 6·N·D roofline bookkeeping)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        if self.family == "encdec":
            per = 4 * d * self.n_heads * self.head_dim + 2 * d * self.d_ff
            enc = self.enc_layers * per
            dec = self.dec_layers * (per + 4 * d * self.n_heads * self.head_dim)
            return emb + enc + dec
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.mla:
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        if self.family == "ssm":
            per = (d * (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                        + self.ssm_heads)
                   + self.d_inner * d)
            return emb + L * per
        mlp = 3 * d * self.d_ff if self.mlp == "swiglu" else 2 * d * self.d_ff
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.moe_d_ff \
                + self.n_shared_experts * 3 * d * (self.moe_d_ff *
                                                   max(self.n_shared_experts, 1))
            n_moe_layers = L - self.first_dense_layers
            return emb + L * attn + self.first_dense_layers * mlp \
                + n_moe_layers * moe
        if self.family == "hybrid":
            ssm_per = (d * (2 * self.d_inner + 2 * self.ssm_groups
                            * self.ssm_state + self.ssm_heads)
                       + self.d_inner * d)
            shared = attn + mlp
            return emb + L * (ssm_per + mlp) + shared
        return emb + L * (attn + mlp)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.mla:
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        mlp = 3 * d * self.d_ff
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff
        n_moe = L - self.first_dense_layers
        return emb + L * attn + self.first_dense_layers * mlp + n_moe * active_moe

    def shape(self, shape_name: str) -> Tuple[int, int, str]:
        return SHAPES[shape_name]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
