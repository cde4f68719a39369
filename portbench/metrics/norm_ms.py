"""Device ms a window step owned by the port's ``repro_torch.norm`` span
(``nn/layers.py::apply_rmsnorm``, ``apply_layernorm``: every norm, the
qk-norms and MLA's latent norm too), with the backward of its forward
operators (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.norm")
