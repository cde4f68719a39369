"""Fused GEMM + LeakyReLU epilogue: the hand-written Hopper kernel
(``csrc/gemm.cu``) behind a checked wrapper, and the kernel's schedule
spec for the optimizer.

Port of ``repro/kernels/matmul_leakyrelu.py`` (paper Table 2, Fig. 6
"mmLeakyReLu"; the kernel whose §5.7.1 reuse-cache move the paper
traces).  The kernel's note in ``csrc/gemm.cu`` says what bounds it on the
card and what its design does about that.  On CPU tensors the wrapper
computes the plain version (:func:`repro_torch.kernels.ref.matmul_leakyrelu`);
on CUDA tensors it launches the kernel or raises.

``make_spec`` / ``CONFIGS`` are the schedule optimizer's view of the
kernel (its steady-state tile loop and autotune space), as in the
reference; ``tile_fn`` and ``epilogue_fn`` are torch functions that
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


def matmul_leakyrelu(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                     bn: int = 128, bk: int = 128,
                     negative_slope: float = 0.01) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> LeakyReLU(a @ b) (M, N) in a's type.

    ``bm``/``bn``/``bk`` are the reference's block sizes: M, N and K must
    be multiples of them, as the reference asserts.  The CUDA kernel's own
    tiling does not depend on them (see ``csrc/gemm.cu``)."""
    global launches
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul_leakyrelu: need a (M, K) and b (K, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if not (k == k2 and m % bm == 0 and n % bn == 0 and k % bk == 0):
        raise AssertionError((tuple(a.shape), tuple(b.shape), bm, bn, bk))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul_leakyrelu(a, b, negative_slope)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"matmul_leakyrelu: a on {a.device} and b on "
                         f"{b.device}; the kernel needs one CUDA device")
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"matmul_leakyrelu: a and b must share f32 or bf16, "
                        f"got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_leakyrelu: a and b must be contiguous")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _build.library().repro_matmul_leakyrelu(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
        float(negative_slope), _build.DTYPE_CODES[a.dtype],
        _build.stream_handle(a.device))
    _build.check(err, "matmul_leakyrelu")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict, *, scenario: Optional[Scenario] = None
              ) -> KernelSpec:
    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    dtype = scenario.dtype if scenario is not None else "bf16"
    return KernelSpec(
        name="matmul_leakyrelu",
        tile_fn=lambda a, b: (a @ b,),
        epilogue_fn=lambda acc: (torch.where(acc >= 0, acc, 0.01 * acc),),
        inputs=[TileIO("a", (bm, bk), dtype=dtype),
                TileIO("b", (bk, bn), dtype=dtype)],
        outputs=[TileIO("y", (bm, bn), dtype=dtype)],
        steps=scenario_steps(scenario, bm, default=3),
        accumulate=True,
        config=dict(cfg),
        flops_per_step=2 * bm * bn * bk,
    )


CONFIGS = [
    {"bm": 128, "bn": 128, "bk": 128},
    {"bm": 128, "bn": 128, "bk": 64},
    {"bm": 64, "bn": 128, "bk": 128},
    {"bm": 128, "bn": 256, "bk": 64},
    {"bm": 256, "bn": 128, "bk": 64},
]
