"""Root-mean-square layer normalization: the hand-written Hopper kernel
(``csrc/rmsnorm.cu``) behind a checked wrapper, and the kernel's schedule
spec for the optimizer.

Port of ``repro/kernels/rmsnorm.py`` (paper Table 2 "rmsnorm").  The
kernel's note in ``csrc/rmsnorm.cu`` says what bounds it on the card and
what its design does about that.  On a CPU tensor the wrapper computes
the plain version (:func:`repro_torch.kernels.ref.rmsnorm`); on a CUDA
tensor it launches the kernel or raises.

:class:`RMSNormFunction` is the differentiable form: its forward launches
the kernel, its backward gives the gradients of x and gamma by autograd
through the plain version, recomputed from the saved inputs.  The JAX
package has no backward kernel, so none is owed here.

``make_spec`` / ``CONFIGS`` are the schedule optimizer's view of the
kernel (its steady-state tile loop and autotune space), as in the
reference; ``tile_fn`` is a torch function that
:mod:`repro_torch.sched.lowering` traces.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.scenario import Scenario, scenario_steps
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
            br: Optional[int] = None,
            cols: Optional[int] = None) -> torch.Tensor:
    """x: (rows, cols), gamma: (cols,) -> (rows, cols) in x's type.

    ``br`` is the reference's rows per program: rows must be a multiple
    of it when it is given, as the reference asserts.  ``cols`` is the
    width a deployed config names; it must equal x's.  The CUDA kernel's
    grid does not depend on either (see ``csrc/rmsnorm.cu``)."""
    global launches
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: need x (rows, cols) and gamma (cols,), "
                         f"got {tuple(x.shape)} and {tuple(gamma.shape)}")
    if br is not None and x.shape[0] % br:
        raise AssertionError((tuple(x.shape), br))
    if cols is not None and cols != x.shape[1]:
        raise ValueError(f"rmsnorm: the config's cols={cols} is not x's "
                         f"width {x.shape[1]}")
    if x.device.type == "cpu" and gamma.device.type == "cpu":
        return ref.rmsnorm(x, gamma, eps)
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"rmsnorm: x on {x.device} and gamma on "
                         f"{gamma.device}; the kernel needs one CUDA device")
    if x.dtype not in _build.DTYPE_CODES or gamma.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x and gamma must share f32 or bf16, got "
                        f"{x.dtype} and {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    y = torch.empty_like(x)
    lib = _build.library()
    err = lib.repro_rmsnorm(x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                            x.shape[0], x.shape[1], float(eps),
                            _build.DTYPE_CODES[x.dtype],
                            _build.stream_handle(x.device))
    _build.check(err, "rmsnorm")
    launches += 1
    return y


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` with gradients for x and gamma: the kernel forward,
    the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rmsnorm(x, gamma, eps=eps)

    @staticmethod
    def backward(ctx, grad_y):
        x, gamma = ctx.saved_tensors
        xr = x.detach().requires_grad_()
        gr = gamma.detach().requires_grad_()
        with torch.enable_grad():
            y = ref.rmsnorm(xr, gr, ctx.eps)
        dx, dgamma = torch.autograd.grad(y, (xr, gr), grad_y)
        return dx, dgamma, None


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict, *, scenario: Optional[Scenario] = None
              ) -> KernelSpec:
    br, cols = cfg["br"], cfg["cols"]
    dtype = scenario.dtype if scenario is not None else "bf16"

    def tile_fn(x, g):
        var = torch.mean(x * x, -1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6) * g,)

    return KernelSpec(
        name="rmsnorm",
        tile_fn=tile_fn,
        inputs=[TileIO("x", (br, cols), dtype=dtype),
                TileIO("g", (1, cols), dtype=dtype, invariant=True)],
        outputs=[TileIO("y", (br, cols), dtype=dtype)],
        steps=scenario_steps(scenario, br, default=4),
        accumulate=False,
        config=dict(cfg),
        flops_per_step=4 * br * cols,
    )


# paper configuration: rmsnorm on (1, 32, 4096, 64) -> rows=32*4096, cols=64;
# practical LLM widths included in the sweep
CONFIGS = [
    {"br": 8, "cols": 2048},
    {"br": 16, "cols": 2048},
    {"br": 8, "cols": 4096},
    {"br": 32, "cols": 1024},
]
