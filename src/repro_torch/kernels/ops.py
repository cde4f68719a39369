"""Dispatching wrappers: one call site per op, selectable implementation.

``impl=None`` (the default) follows the tensor's device: the
hand-written kernel's wrapper, which launches the CUDA kernel for CUDA
tensors and computes the plain version for CPU tensors.  ``impl="ref"``
forces the plain PyTorch version on any device (what ``chip_smoke.py``
holds the kernels against); ``impl="cuda"`` demands the kernel and
raises for a CPU tensor.  Model code (``repro_torch.nn.layers``) calls
these, so the serving path goes through the kernels on the card.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.kernels import fused_ff as _ff_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms_mod

Impl = Optional[Literal["ref", "cuda"]]


def _use_ref(impl: Impl, x: torch.Tensor, name: str) -> bool:
    if impl == "ref":
        return True
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    if impl not in (None, "cuda"):
        raise ValueError(f"{name}: impl must be None, 'ref' or 'cuda', "
                         f"got {impl!r}")
    return False


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, impl: Impl = None,
            eps: float = 1e-6) -> torch.Tensor:
    if _use_ref(impl, x, "rmsnorm"):
        return ref.rmsnorm(x, gamma, eps)
    return _rms_mod.rmsnorm(x, gamma, eps=eps)


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
             impl: Impl = None) -> torch.Tensor:
    if _use_ref(impl, x, "fused_ff"):
        return ref.fused_ff(x, w_gate, w_up)
    return _ff_mod.fused_ff(x, w_gate, w_up)
