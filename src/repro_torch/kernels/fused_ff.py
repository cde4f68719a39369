"""Fused LLaMA feed-forward front half, silu(x@Wg) * (x@Wu): the
hand-written Hopper kernel (``csrc/fused_ff.cu``) behind a checked
wrapper, and the kernel's schedule spec for the optimizer.

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

``make_spec`` / ``CONFIGS`` are the schedule optimizer's view of the
kernel (its steady-state tile loop and autotune space), as in the
reference; ``tile_fn`` and ``epilogue_fn`` are torch functions that
:mod:`repro_torch.sched.lowering` traces.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
             bm: Optional[int] = None, bn: Optional[int] = None,
             bk: Optional[int] = None) -> torch.Tensor:
    """x: (M, K); w_gate, w_up: (K, N) -> (M, N) in x's type.

    ``bm``/``bn``/``bk`` are the reference's block sizes: M, N and K must
    be multiples of those given, as the reference asserts.  The CUDA
    kernel's own tiling does not depend on them (see ``csrc/fused_ff.cu``)."""
    global launches
    if x.ndim != 2 or w_gate.ndim != 2 or w_gate.shape != w_up.shape \
            or w_gate.shape[0] != x.shape[1]:
        raise ValueError(f"fused_ff: need x (M, K) and two (K, N) weights, "
                         f"got {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    M, K = x.shape
    N = w_gate.shape[1]
    if any(b is not None and dim % b
           for dim, b in ((M, bm), (N, bn), (K, bk))):
        raise AssertionError((tuple(x.shape), tuple(w_gate.shape), bm, bn,
                              bk))
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


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict) -> KernelSpec:
    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]

    def tile_fn(x, wg, wu):
        return x @ wg, x @ wu

    def epilogue_fn(g, u):
        return (F.silu(g) * u,)

    return KernelSpec(
        name="fused_ff",
        tile_fn=tile_fn,
        epilogue_fn=epilogue_fn,
        inputs=[TileIO("x", (bm, bk)), TileIO("wg", (bk, bn)),
                TileIO("wu", (bk, bn))],
        outputs=[TileIO("h", (bm, bn))],
        steps=3,
        accumulate=True,
        config=dict(cfg),
        flops_per_step=4 * bm * bn * bk,
    )


CONFIGS = [
    {"bm": 128, "bn": 128, "bk": 128},
    {"bm": 128, "bn": 128, "bk": 64},
    {"bm": 64, "bn": 256, "bk": 64},
    {"bm": 256, "bn": 128, "bk": 64},
]
