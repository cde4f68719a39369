"""The yardstick's arithmetic: the chip's peaks, the model FLOPs of a
training step, and the least time of a kernel call.

Frozen here so that a later change to the program cannot move it.

* Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
  989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in float32 outside the tensor
  cores, 3.35 TB/s of HBM.  The same constants as the port's
  ``launch/roofline.py``.
* Model FLOPs count what the model needs, whatever computes it:
  ``6 * n_active * tokens`` for the products of the forward and backward
  passes, where ``n_active`` counts the parameters a token's products
  use (the attention projections, the dense MLPs, the router and the
  ``top_k`` routed plus the shared experts of an MoE layer, the other
  mixers' projections, and the head; not the embedding lookup nor the
  norms), plus attention's causal score work,
  ``6 * B * H * S**2 * (D_qk + D_v) / 2`` an attention layer, plus the
  other mixers' own work, which the model type's module gives as
  ``mixer_flops`` (a Mamba-2 layer's SSD scan: :func:`ssd_flops`).
  Recomputation is not counted, nor is the extra work of a chunked or
  blocked algorithm: the SSD scan counts its recurrence's two products
  however the kernel cuts the sequence.
* A model type's module under ``portbench/reference/`` may define
  ``attention_layers(c)``, the number of its layers that attend, where
  that is not ``num_hidden_layers``, and ``mixer_flops(c, seq, batch)``.
* A kernel call's bound is ``max(FLOPs / peak, bytes / HBM)`` with each
  input read and each output written once.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _family(c: Dict):
    from portbench.reference import model
    return model.family(c)


def n_active(c: Dict) -> int:
    """Parameters that take part in a token's products (the model type's
    module under ``portbench/reference/`` counts them)."""
    return _family(c).active_params(c)


def attention_flops(c: Dict, seq: int, batch: int) -> float:
    """Causal score work of a training step (forward and backward)."""
    family = _family(c)
    h, _, dq, dv = family.attention_dims(c)
    layers = (family.attention_layers(c)
              if hasattr(family, "attention_layers")
              else c["num_hidden_layers"])
    return layers * 6.0 * batch * h * seq * seq * (dq + dv) / 2


def mixer_flops(c: Dict, seq: int, batch: int) -> float:
    """The work of a training step's mixers other than attention beyond
    their projections (forward and backward); 0 for a model type that
    gives none."""
    family = _family(c)
    if not hasattr(family, "mixer_flops"):
        return 0
    return family.mixer_flops(c, seq, batch)


def ssd_flops(batch: int, seq: int, heads: int, head_p: int,
              state: int) -> float:
    """A Mamba-2 layer's SSD scan in a training step: the recurrence's
    state update ``x (x) b`` and read-out ``h . c``, ``2 * P * N`` FLOPs
    each a position and head, three times over for the forward and
    backward passes."""
    return 12.0 * batch * seq * heads * head_p * state


def model_flops(c: Dict, seq: int, batch: int) -> float:
    """Model FLOPs of one training step of ``batch`` rows of ``seq``."""
    return (6.0 * n_active(c) * seq * batch + attention_flops(c, seq, batch)
            + mixer_flops(c, seq, batch))


def _bound(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def flash_attention_cost(q: Sequence[int], k: Sequence[int],
                         v: Sequence[int], causal: bool, dtype: str):
    """(FLOPs, bytes) of one attention call: q (B, H, Sq, D), k (B, KH,
    Sk, D), v (B, KH, Sk, Dv); a causal call over Sq == Sk computes half
    of the score matrix."""
    b, h, sq, dq = q
    kh, sk = k[1], k[2]
    dv = v[3]
    flops = 2.0 * b * h * sq * sk * (dq + dv)
    if causal and sq == sk:
        flops /= 2
    elems = b * h * sq * dq + b * kh * sk * (dq + dv) + b * h * sq * dv
    return flops, elems * BYTES[dtype]


def flash_attention_bound(q, k, v, causal: bool, dtype: str) -> float:
    return _bound(*flash_attention_cost(q, k, v, causal, dtype), dtype)


def fused_ff_cost(x: Sequence[int], w: Sequence[int], dtype: str):
    """(FLOPs, bytes) of one ``silu(x @ Wg) * (x @ Wu)``: x (M, K), Wg and
    Wu (K, N), out (M, N)."""
    m, k = x
    n = w[1]
    return 4.0 * m * k * n, (m * k + 2 * k * n + m * n) * BYTES[dtype]


def fused_ff_bound(x, w, dtype: str) -> float:
    return _bound(*fused_ff_cost(x, w, dtype), dtype)


def ssd_cost(x: Sequence[int], a: Sequence[int], b: Sequence[int],
             dtype: str):
    """(FLOPs, bytes) of one ``repro_torch::ssd_chunk`` call: x and y
    (B, S, H, P) in ``dtype``, the log-decay a (B, S, H) in float32, b and
    c (B, S, G, N) in ``dtype``; the recurrence's two products,
    ``4 * P * N`` FLOPs a position and head."""
    bsz, seq, heads, head_p = x
    groups, state = b[2], b[3]
    flops = 4.0 * bsz * seq * heads * head_p * state
    nbytes = ((2 * bsz * seq * heads * head_p
               + 2 * bsz * seq * groups * state) * BYTES[dtype]
              + math.prod(a) * BYTES["float32"])
    return flops, nbytes


def ssd_bound(x, a, b, dtype: str) -> float:
    return _bound(*ssd_cost(x, a, b, dtype), dtype)
