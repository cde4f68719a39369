"""Tokens of the window's completed steps over the time from the first
step's start to the last step's end (host clock; each step ends in the
Trainer's device sync)."""


def read(rec):
    return rec.tokens_per_step * len(rec.steps) / rec.window_s
