"""Device ms a window step of the kernels launched in the steps that no
program span claims, forward or backward: the rest of the partition
whose other parts are ``attn_ms``, ``mlp_ms``, ``norm_ms``, the MoE's
two, ``vocab_ms`` and ``optim_ms`` (:mod:`portbench.spans`)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    return None if s is None else s.ms_per_step(None)
