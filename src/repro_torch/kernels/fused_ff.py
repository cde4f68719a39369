"""Fused LLaMA feed-forward front half, silu(x@Wg) * (x@Wu): the
hand-written Hopper kernel (``csrc/fused_ff.cu``) behind a checked
wrapper.

Port of ``repro/kernels/fused_ff.py`` (paper Table 2 "fused_ff").  The
kernel's note in ``csrc/fused_ff.cu`` says what bounds it on the card and
what its design does about that.  On CPU tensors the wrapper computes the
plain version (:func:`repro_torch.kernels.ref.fused_ff`); on CUDA tensors
it launches the kernel or raises.

:class:`FusedFFFunction` is the differentiable form: its forward launches
the kernel, its backward gives the gradients of x and both weights by
autograd through the plain version (f32 math, as the kernel's), recomputed
from the saved inputs.  The JAX package has no backward kernel, so none is
owed here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor) -> torch.Tensor:
    """x: (M, K); w_gate, w_up: (K, N) -> (M, N) in x's type."""
    global launches
    if x.ndim != 2 or w_gate.ndim != 2 or w_gate.shape != w_up.shape \
            or w_gate.shape[0] != x.shape[1]:
        raise ValueError(f"fused_ff: need x (M, K) and two (K, N) weights, "
                         f"got {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    tensors = (x, w_gate, w_up)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.fused_ff(x, w_gate, w_up)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("fused_ff: the kernel needs all three tensors on "
                         "one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if x.dtype not in _build.DTYPE_CODES \
            or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("fused_ff: x and both weights must share f32 or "
                        "bf16, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_ff: x and both weights must be contiguous")
    M, K = x.shape
    N = w_gate.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.repro_fused_ff(x.data_ptr(), w_gate.data_ptr(),
                             w_up.data_ptr(), out.data_ptr(), M, K, N,
                             _build.DTYPE_CODES[x.dtype],
                             _build.stream_handle(x.device))
    _build.check(err, "fused_ff")
    launches += 1
    return out


class FusedFFFunction(torch.autograd.Function):
    """``fused_ff`` with gradients for x, Wg and Wu: the kernel forward,
    the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return fused_ff(x, w_gate, w_up)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.fused_ff(*inputs)
        return torch.autograd.grad(out, inputs, grad_out)
