"""Device ms a window step owned by the port's ``repro_torch.mlp`` span
(``nn/layers.py::apply_swiglu``, ``apply_gelu_mlp``: the dense MLP on K2
and the MoE's shared experts), with the backward of its forward
operators (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.mlp")
