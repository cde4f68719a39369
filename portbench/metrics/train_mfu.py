"""Model FLOPs of the window's steps (``portbench.counts.model_flops``)
over the window's seconds times the chip's peak for the configuration's
type, in percent."""

from portbench import counts


def read(rec):
    flops = rec.model_flops_per_step * len(rec.steps)
    return 100.0 * flops / (rec.window_s * counts.PEAK_FLOPS[rec.dtype])
