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

import collections
import functools
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.scenario import Scenario, scenario_steps
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch),
# in all and by the tiling that ran.
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()

# The kernel instances compiled in csrc/rmsnorm.cu, by id (its kTilings):
# element loads a block a row (unaligned or ragged rows), 16-byte vectors
# a block a row (the model's calls on wide rows) and with br rows a block
# (the br values of CONFIGS), then the narrow-row instances lanesL_vecR:
# L lanes of a warp hold a row, R vectors a lane, in registers (the
# model's calls on rows of at most NARROW_ROW_BYTES).
SCALAR, BLOCK_ROW = "scalar", "block_row"
BLOCK_BR = (8, 16, 32)
NARROW = ((8, 1), (16, 1), (32, 1), (32, 2), (32, 4))   # (L, R)
NARROW_TILINGS = tuple(f"lanes{lanes}_vec{vec}" for lanes, vec in NARROW)
TILINGS = ((SCALAR, BLOCK_ROW) + tuple(f"block_br{br}" for br in BLOCK_BR)
           + NARROW_TILINGS)

# The widest row, in bytes, that a call naming no br sends to a narrow
# instance: the widest instance's, 32 lanes x 4 vectors.  chip_smoke.py's
# width sweep (bf16, 8192 rows) set the table: each narrow width ran
# faster than block_row, and at 4096 bytes (2048 columns) 32 lanes of 8
# vectors (188 registers, one block an SM) only tied it (csrc/rmsnorm.cu's
# note), so that instance is not built.
NARROW_ROW_BYTES = 16 * max(lanes * vec for lanes, vec in NARROW)


def narrow_tiling(dtype: torch.dtype, cols: int) -> Optional[str]:
    """The smallest narrow instance whose L x R vectors hold a row of
    ``cols`` elements of ``dtype``, or None where none does."""
    nvec = -(-cols * dtype.itemsize // 16)
    for (lanes, vec), name in zip(NARROW, NARROW_TILINGS):
        if lanes * vec >= nvec:
            return name
    return None


@functools.lru_cache(maxsize=1024)
def select_tiling(dtype: torch.dtype, shape: Sequence[int], *,
                  br: Optional[int] = None, cols: Optional[int] = None,
                  aligned: bool = True) -> str:
    """The ``csrc/rmsnorm.cu`` instance (a name of ``TILINGS``) that
    ``rmsnorm`` launches for x of ``shape`` (rows, cols) in ``dtype`` at
    the deployed ``br`` (``cols`` is the config's width, checked by the
    wrapper): ``scalar`` for rows whose width is not a multiple of the
    16-byte vector or tensors not 16-byte aligned (``aligned``); else,
    when br is None (the model's calls), the smallest narrow instance
    that holds the row (:func:`narrow_tiling`) for rows of at most
    ``NARROW_ROW_BYTES`` and ``block_row`` for wider ones; ``block_row``
    for br 1, and the instance of ``br`` rows a block for any other br,
    at any width.  A br with no compiled instance raises, listing the
    instances."""
    if not aligned or shape[1] % (16 // dtype.itemsize):
        return SCALAR
    if br is None:
        if shape[1] * dtype.itemsize <= NARROW_ROW_BYTES:
            return narrow_tiling(dtype, shape[1])
        return BLOCK_ROW
    if br == 1:
        return BLOCK_ROW
    name = f"block_br{br}"
    if name not in TILINGS:
        raise ValueError(f"rmsnorm: no kernel instance {name} for br={br}; "
                         f"compiled: {', '.join(TILINGS)}")
    return name


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
            br: Optional[int] = None,
            cols: Optional[int] = None) -> torch.Tensor:
    """x: (rows, cols), gamma: (cols,) -> (rows, cols) in x's type.

    ``br`` is the reference's rows per program: rows must be a multiple
    of it when it is given, as the reference asserts.  ``cols`` is the
    width a deployed config names; it must equal x's.  On the card the
    instance :func:`select_tiling` names for ``br`` runs, and
    ``launches_by_tiling`` counts which ran (see ``csrc/rmsnorm.cu``)."""
    global launches
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: need x (rows, cols) and gamma (cols,), "
                         f"got {tuple(x.shape)} and {tuple(gamma.shape)}")
    if br is not None and x.shape[0] % br:
        raise AssertionError((tuple(x.shape), br))
    if cols is not None and cols != x.shape[1]:
        raise ValueError(f"rmsnorm: the config's cols={cols} is not x's "
                         f"width {x.shape[1]}")
    device = x.device
    if device.type == "cpu" and gamma.device.type == "cpu":
        return ref.rmsnorm(x, gamma, eps)
    if device.type != "cuda" or gamma.device != device:
        raise ValueError(f"rmsnorm: x on {device} and gamma on "
                         f"{gamma.device}; the kernel needs one CUDA device")
    dtype = x.dtype
    if dtype not in _build.DTYPE_CODES or gamma.dtype != dtype:
        raise TypeError(f"rmsnorm: x and gamma must share f32 or bf16, got "
                        f"{dtype} and {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    y = torch.empty_like(x)
    ptrs = x.data_ptr(), gamma.data_ptr(), y.data_ptr()
    tiling = select_tiling(dtype, x.shape, br=br,
                           aligned=(ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0)
    rows, cols = x.shape
    err = _build.library().repro_rmsnorm(
        *ptrs, rows, cols, float(eps),
        _build.tiling_ids("repro_rmsnorm_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[dtype], _build.stream_handle(device))
    _build.check(err, f"rmsnorm ({tiling})")
    launches += 1
    launches_by_tiling[tiling] += 1
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
