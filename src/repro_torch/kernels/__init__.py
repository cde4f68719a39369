"""Hand-written Hopper kernels for the TPU kernels on the port's paths,
and the registry the schedule optimizer resolves kernel names through.

Each kernel is CUDA C++ under ``csrc/`` (built by ``_build`` with
``nvcc`` for ``sm_90a`` at first use), wrapped by a module that checks
its inputs, launches it on PyTorch's current stream and counts its
launches, with its plain PyTorch version in :mod:`ref`.  :mod:`ops`
dispatches between the two, and the model kernels' ``autograd.Function``s
give them a gradient.  Ported so far: ``rmsnorm``, ``fused_ff``,
``flash_attention``, ``matmul_leakyrelu`` and ``bmm``; the other two TPU
kernels are listed in ``ROADMAP.md``.

``KERNELS`` is the registry (port of the reference's
``repro/kernels/__init__.py``): a :class:`KernelDef` per optimizable
kernel holds its schedule spec constructor, its autotune configs, the Hopper
kernel's wrapper (``kernel_fn``) and its plain version (``ref_fn``).  It
registers the §5.7 pair; the other kernels' specs are ROADMAP A10.

    from repro_torch.kernels import register_kernel
    from repro_torch.sched import KernelDef

    register_kernel(KernelDef("my_kernel", make_spec, CONFIGS))
"""

from typing import Dict

from repro_torch.kernels import (bmm, flash_attention, fused_ff,
                                 matmul_leakyrelu, ops, ref, rmsnorm)
from repro_torch.sched.session import KernelDef

KERNELS: Dict[str, KernelDef] = {}


def register_kernel(kdef: KernelDef) -> KernelDef:
    """Register ``kdef`` under its name (last registration wins, so tests
    can shadow and restore entries).  Returns the definition."""
    if not isinstance(kdef, KernelDef):
        raise TypeError(f"register_kernel expects a KernelDef, got {kdef!r}")
    KERNELS[kdef.name] = kdef
    return kdef


def unregister_kernel(name: str) -> None:
    """Remove a registry entry (test cleanup)."""
    KERNELS.pop(name, None)


def get_kernel(name: str) -> KernelDef:
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered kernels: "
                       f"{sorted(KERNELS)}") from None


register_kernel(KernelDef(
    "matmul_leakyrelu", matmul_leakyrelu.make_spec, matmul_leakyrelu.CONFIGS,
    matmul_leakyrelu.matmul_leakyrelu, ref.matmul_leakyrelu))
register_kernel(KernelDef("bmm", bmm.make_spec, bmm.CONFIGS, bmm.bmm,
                          ref.bmm))

__all__ = ["KERNELS", "KernelDef", "bmm", "flash_attention", "fused_ff",
           "get_kernel", "matmul_leakyrelu", "ops", "ref",
           "register_kernel", "rmsnorm", "unregister_kernel"]
