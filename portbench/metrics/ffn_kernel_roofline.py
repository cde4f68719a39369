"""K2 (``repro_torch::fused_ff``): the summed least time of its calls in
the traced window, from each call's shapes, over the summed device time
of the kernels the calls launched, in percent."""

from portbench import counts
from portbench.trace import shapes


def read(rec):
    if rec.trace is None:
        return None

    def bound(event):
        s = shapes(event)
        if len(s) < 2 or len(s[0]) != 2:
            return None
        return counts.fused_ff_bound(s[0], s[1], rec.dtype)

    return rec.trace.roofline("repro_torch::fused_ff", bound)
