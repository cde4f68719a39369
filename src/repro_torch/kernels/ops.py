"""Dispatching wrappers: one call site per op, selectable implementation.

``impl=None`` (the default) follows the tensor's device: CUDA tensors go
through the kernel's differentiable form (its ``autograd.Function``: the
hand-written kernel forward, the plain version's gradient backward), CPU
tensors through the plain version, which autograd differentiates as it
is.  ``impl="ref"`` forces the plain PyTorch version on any device (what
``chip_smoke.py`` holds the kernels against); ``impl="cuda"`` demands the
kernel and raises for a CPU tensor.  ``with forced("ref"):`` makes every
call inside that passes no ``impl`` take the plain versions, so a whole
model can be evaluated without the kernels on the card.  Model code
(``repro_torch.nn``) calls these, so the serving and training paths go
through the kernels on the card.  ``matmul_leakyrelu`` and ``bmm`` have
no gradient (nothing trains through them, as in the reference): on CUDA
tensors they launch the kernel itself.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Literal, Optional

import torch

from repro_torch.kernels import bmm as _bmm_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import fused_ff as _ff_mod
from repro_torch.kernels import matmul_leakyrelu as _mlr_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms_mod

Impl = Optional[Literal["ref", "cuda"]]

_forced: Impl = None     # what ``forced`` set, for every thread


@contextlib.contextmanager
def forced(impl: Impl) -> Iterator[None]:
    """Calls made while this is open that pass no ``impl`` use ``impl``.

    Process-wide, not per thread: autograd runs a CUDA backward pass (and
    the layers it recomputes) on threads of its own, which must see the
    same choice as the forward pass."""
    global _forced
    before, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = before


def _use_ref(impl: Impl, name: str, *tensors: torch.Tensor) -> bool:
    if impl is None:
        impl = _forced
    if impl not in (None, "ref", "cuda"):
        raise ValueError(f"{name}: impl must be None, 'ref' or 'cuda', "
                         f"got {impl!r}")
    if impl == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got "
                         + ", ".join(str(t.device) for t in tensors))
    return impl == "ref" or all(t.device.type == "cpu" for t in tensors)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, impl: Impl = None,
            eps: float = 1e-6) -> torch.Tensor:
    if _use_ref(impl, "rmsnorm", x, gamma):
        return ref.rmsnorm(x, gamma, eps)
    return _rms_mod.RMSNormFunction.apply(x, gamma, eps)


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
             impl: Impl = None) -> torch.Tensor:
    if _use_ref(impl, "fused_ff", x, w_gate, w_up):
        return ref.fused_ff(x, w_gate, w_up)
    return _ff_mod.FusedFFFunction.apply(x, w_gate, w_up)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = ref.NO_WINDOW,
                    q_offset: int = 0, scale: Optional[float] = None,
                    impl: Impl = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D) -> (B, H, Sq, D)."""
    if _use_ref(impl, "flash_attention", q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    return _fa_mod.FlashAttentionFunction.apply(q, k, v, causal, window,
                                                q_offset, scale)


def matmul_leakyrelu(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                     bn: int = 128, bk: int = 128,
                     negative_slope: float = 0.01,
                     impl: Impl = None) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> LeakyReLU(a @ b).  The kernel takes M, N, K
    that are multiples of the block sizes, as the reference's kernel
    asserts; the plain version, as the reference's oracle, takes any."""
    if _use_ref(impl, "matmul_leakyrelu", a, b):
        return ref.matmul_leakyrelu(a, b, negative_slope)
    return _mlr_mod.matmul_leakyrelu(a, b, bm=bm, bn=bn, bk=bk,
                                     negative_slope=negative_slope)


def bmm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
        bk: int = 128, impl: Impl = None) -> torch.Tensor:
    """a: (B, M, K), b: (B, K, N) -> a @ b, with the block-size contract
    of :func:`matmul_leakyrelu`."""
    if _use_ref(impl, "bmm", a, b):
        return ref.bmm(a, b)
    return _bmm_mod.bmm(a, b, bm=bm, bn=bn, bk=bk)
