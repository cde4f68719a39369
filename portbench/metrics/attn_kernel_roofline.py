"""K6 (``repro_torch::flash_attention``): the summed least time of its
calls in the traced window, from each call's shapes, over the summed
device time of the kernels the calls launched, in percent."""

from portbench import counts
from portbench.trace import scalar_input, shapes

CAUSAL_ARG = 3      # (q, k, v, causal, window, q_offset, scale)


def read(rec):
    if rec.trace is None:
        return None

    def bound(event):
        s = shapes(event)
        if len(s) < 3 or len(s[0]) != 4:
            return None
        causal = bool(scalar_input(event, CAUSAL_ARG, True))
        return counts.flash_attention_bound(s[0], s[1], s[2], causal,
                                            rec.dtype)

    return rec.trace.roofline("repro_torch::flash_attention", bound)
