"""K6's gradient kernel (``repro_torch::flash_attention_backward``): the
summed least time of its calls in the traced window, from each call's
shapes, over the summed device time of the kernels the calls launched,
in percent; None where no call launched a kernel (a program whose
attention gradient runs no such operator).

A call's work is the five products of the FlashAttention backward, S,
dP, dV, dq and dK: ``2 * B * H * Sq * Sk * (3 * D + 2 * Dv)`` FLOPs,
halved when causal over Sq == Sk; its bytes are q, k, v, the output, its
gradient and the log-sum-exp read once, and dq, dk and dv written once."""

import math

from portbench import counts
from portbench.trace import scalar_input, shapes

# (q, k, v, out, lse, grad_out, causal, window, q_offset, scale)
CAUSAL_ARG = 6


def cost(q, k, v, lse, causal, dtype):
    """(FLOPs, bytes) of one call: q (B, H, Sq, D), k (B, KH, Sk, D), v
    (B, KH, Sk, Dv), lse of f32 (any shape)."""
    b, h, sq, dq = q
    kh, sk = k[1], k[2]
    dv = v[3]
    flops = 2.0 * b * h * sq * sk * (3 * dq + 2 * dv)
    if causal and sq == sk:
        flops /= 2
    reads = b * h * sq * (dq + 2 * dv) + b * kh * sk * (dq + dv)
    writes = b * h * sq * dq + b * kh * sk * (dq + dv)
    return flops, (reads + writes) * counts.BYTES[dtype] + 4 * math.prod(lse)


def read(rec):
    if rec.trace is None:
        return None

    def bound(event):
        s = shapes(event)
        if len(s) < 6 or len(s[0]) != 4:
            return None
        causal = bool(scalar_input(event, CAUSAL_ARG, True))
        return counts._bound(*cost(s[0], s[1], s[2], s[4], causal,
                                   rec.dtype), rec.dtype)

    return rec.trace.roofline("repro_torch::flash_attention_backward", bound)
