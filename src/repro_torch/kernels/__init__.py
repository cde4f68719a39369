"""Hand-written Hopper kernels for the TPU kernels on the port's path.

Each kernel is CUDA C++ under ``csrc/`` (built by ``_build`` with
``nvcc`` for ``sm_90a`` at first use), wrapped by a module that checks
its inputs, launches it on PyTorch's current stream and counts its
launches, with its plain PyTorch version in :mod:`ref`.  :mod:`ops`
dispatches between the two, and each kernel's ``autograd.Function``
gives it a gradient.  Ported so far: ``rmsnorm``, ``fused_ff`` and
``flash_attention``; the other four TPU kernels are listed in
``ROADMAP.md``.
"""

from repro_torch.kernels import flash_attention, fused_ff, ops, ref, rmsnorm

__all__ = ["flash_attention", "fused_ff", "ops", "ref", "rmsnorm"]
