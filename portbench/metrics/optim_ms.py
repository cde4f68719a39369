"""Device ms a window step owned by the port's ``repro_torch.optim``
span (the train step's clip norm, AdamW and the update)
(:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.optim")
