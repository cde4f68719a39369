"""Hand-written Hopper kernels for the TPU kernels on the port's path.

Each kernel is CUDA C++ under ``csrc/`` (built by ``_build`` with
``nvcc`` for ``sm_90a`` at first use), wrapped by a module that checks
its inputs, launches it on PyTorch's current stream and counts its
launches, with its plain PyTorch version in :mod:`ref`.  :mod:`ops`
dispatches between the two.  Ported so far: ``rmsnorm`` and
``fused_ff``; the other five TPU kernels are listed in ``ROADMAP.md``.
"""

from repro_torch.kernels import fused_ff, ops, ref, rmsnorm

__all__ = ["fused_ff", "ops", "ref", "rmsnorm"]
