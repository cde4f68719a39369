"""Row softmax: the hand-written Hopper kernel (``csrc/softmax.cu``)
behind a checked wrapper, and the kernel's schedule spec for the
optimizer.

Port of ``repro/kernels/softmax.py`` (paper Table 2 "softmax",
memory-bound class; paper configuration n_rows=512, n_cols=4096).  The
kernel's note in ``csrc/softmax.cu`` says what bounds it on the card and
what its design does about that.  On a CPU tensor the wrapper computes
the plain version (:func:`repro_torch.kernels.ref.softmax`); on a CUDA
tensor it launches the kernel or raises.

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

# The kernel holds a row in registers: 32 values of each of 256 threads.
MAX_COLS = 8192

# The kernel instances compiled in csrc/softmax.cu, by id (its kTilings):
# element loads a block a row (unaligned or ragged rows), then 16-byte
# vectors with br rows a block: 1 for calls that name no br, and the br
# values of CONFIGS.
SCALAR = "scalar"
BLOCK_BR = (1, 4, 8, 16, 32)
TILINGS = (SCALAR,) + tuple(f"block_br{br}" for br in BLOCK_BR)


@functools.lru_cache(maxsize=1024)
def select_tiling(dtype: torch.dtype, shape: Sequence[int], *,
                  br: Optional[int] = None, cols: Optional[int] = None,
                  aligned: bool = True) -> str:
    """The ``csrc/softmax.cu`` instance (a name of ``TILINGS``) that
    ``softmax`` launches for x of ``shape`` (rows, cols) in ``dtype`` at
    the deployed ``br`` (``cols`` is the config's width, checked by the
    wrapper): ``scalar`` for rows whose width is not a multiple of the
    16-byte vector or tensors not 16-byte aligned (``aligned``); else the
    instance of ``br`` rows a block (1 when None).  A br with no compiled
    instance raises, listing the instances."""
    if not aligned or shape[1] % (16 // dtype.itemsize):
        return SCALAR
    name = f"block_br{1 if br is None else br}"
    if name not in TILINGS:
        raise ValueError(f"softmax: no kernel instance {name} for br={br}; "
                         f"compiled: {', '.join(TILINGS)}")
    return name


def softmax(x: torch.Tensor, *, br: Optional[int] = None,
            cols: Optional[int] = None) -> torch.Tensor:
    """x: (rows, cols) -> softmax over each row, in x's type.

    ``br`` is the reference's rows per program: rows must be a multiple
    of it, as the reference asserts.  ``cols`` is the width a deployed
    config names; it must equal x's.  On the card the instance
    :func:`select_tiling` names for ``br`` runs, and
    ``launches_by_tiling`` counts which ran (see ``csrc/softmax.cu``)."""
    global launches
    if x.ndim != 2:
        raise ValueError(f"softmax: need x (rows, cols), got "
                         f"{tuple(x.shape)}")
    if br is not None and x.shape[0] % br:
        raise AssertionError((tuple(x.shape), br))
    if cols is not None and cols != x.shape[1]:
        raise ValueError(f"softmax: the config's cols={cols} is not x's "
                         f"width {x.shape[1]}")
    if x.device.type == "cpu":
        return ref.softmax(x)
    if not x.is_cuda:
        raise ValueError(f"softmax: x on {x.device}; the kernel needs a "
                         f"CUDA device")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"softmax: x must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("softmax: x must be contiguous")
    if x.shape[1] > MAX_COLS:
        raise ValueError(f"softmax: the kernel takes cols <= {MAX_COLS}, "
                         f"got {x.shape[1]}")
    y = torch.empty_like(x)
    tiling = select_tiling(x.dtype, x.shape, br=br, aligned=(
        x.data_ptr() | y.data_ptr()) % 16 == 0)
    err = _build.library().repro_softmax(
        x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        _build.tiling_ids("repro_softmax_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check(err, f"softmax ({tiling})")
    launches += 1
    launches_by_tiling[tiling] += 1
    return y


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict, *, scenario: Optional[Scenario] = None
              ) -> KernelSpec:
    br, cols = cfg["br"], cfg["cols"]
    dtype = scenario.dtype if scenario is not None else "bf16"

    def tile_fn(x):
        m = torch.amax(x, -1, keepdim=True)
        e = torch.exp(x - m)
        return (e / torch.sum(e, -1, keepdim=True),)

    return KernelSpec(
        name="softmax",
        tile_fn=tile_fn,
        inputs=[TileIO("x", (br, cols), dtype=dtype)],
        outputs=[TileIO("y", (br, cols), dtype=dtype)],
        steps=scenario_steps(scenario, br, default=4),
        accumulate=False,
        config=dict(cfg),
        flops_per_step=5 * br * cols,
    )


CONFIGS = [
    {"br": 8, "cols": 4096},
    {"br": 16, "cols": 4096},
    {"br": 32, "cols": 2048},
    {"br": 4, "cols": 8192},
]
