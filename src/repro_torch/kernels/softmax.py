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

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.scenario import Scenario, scenario_steps
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0

# The kernel holds a row in registers: 32 values of each of 256 threads.
MAX_COLS = 8192


def softmax(x: torch.Tensor, *, br: Optional[int] = None,
            cols: Optional[int] = None) -> torch.Tensor:
    """x: (rows, cols) -> softmax over each row, in x's type.

    ``br`` is the reference's rows per program: rows must be a multiple
    of it, as the reference asserts.  ``cols`` is the width a deployed
    config names; it must equal x's.  The CUDA kernel's grid does not
    depend on either (see ``csrc/softmax.cu``)."""
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
    err = _build.library().repro_softmax(
        x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check(err, "softmax")
    launches += 1
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
