"""Seconds from the process's start to the window's start: imports, the
Trainer, the weights, the first steps (and, in a fresh checkout, the
kernels' build)."""


def read(rec):
    return rec.setup_s
