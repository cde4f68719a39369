"""Device ms a window step owned by the port's ``repro_torch.attn`` span
(``models/lm.py::apply_attn``: projections, rope, K6, the output
projection; MLA too), the norms nested in it left out, with the backward
of its forward operators (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.attn")
