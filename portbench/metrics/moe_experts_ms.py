"""Device ms a window step owned by the port's ``repro_torch.moe.experts``
span (``nn/moe.py::apply_moe_dense`` and the expert-parallel paths: the
routed experts' products and the gate combine; the router and the shared
experts' MLP nested in it left out), with the backward of its forward
operators (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    return spans.ms_per_step(rec, "repro_torch.moe.experts")
