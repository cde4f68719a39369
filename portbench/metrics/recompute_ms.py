"""Device ms a window step of every kernel with a ``repro_torch.recompute``
span around it: the forward that remat's checkpoint runs again in the
backward pass.  It overlaps the layer metrics, which own these kernels
by the layer spans inside the recompute (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    if s is None or spans.RECOMPUTE not in s.seen:
        return None
    return s.recompute_us / 1e3 / s.steps
