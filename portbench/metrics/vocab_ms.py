"""Device ms a window step owned by the port's vocabulary-sized spans,
``repro_torch.embed``, ``repro_torch.head`` (the final norm nested in it
left out) and ``repro_torch.loss`` (``models/lm.py::embed_forward``,
``head_forward``; ``train/step.py::cross_entropy``), with the backward
of their forward operators (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.embed", "repro_torch.head",
                             "repro_torch.loss")
