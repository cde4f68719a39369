"""The benchmark's own host span around making a step's batch and
copying it to the card, mean over the window's steps, in ms."""

import statistics


def read(rec):
    return 1e3 * statistics.fmean(rec.input_s) if rec.input_s else None
