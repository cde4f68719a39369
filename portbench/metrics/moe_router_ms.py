"""Device ms a window step owned by the port's ``repro_torch.moe.router``
span (``nn/moe.py::router_probs``: the f32 router product, softmax,
top-k), with the backward of its forward operators
(:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.moe.router")
