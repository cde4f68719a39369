"""Batch matrix multiplication: the hand-written Hopper kernel
(``csrc/gemm.cu``) behind a checked wrapper, and the kernel's schedule
spec for the optimizer.

Port of ``repro/kernels/bmm.py`` (paper Table 2 "bmm"; the kernel whose
§5.7.2 predicated-slot move the paper traces).  The kernel's note in
``csrc/gemm.cu`` says what bounds it on the card and what its design does
about that.  On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.bmm`); on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import collections
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul_leakyrelu import (aligned16, gemm_tiling,
                                                  launch_gemm)
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch),
# in all and by the tiling that ran (a name of
# ``matmul_leakyrelu.TILINGS``, the instances of ``csrc/gemm.cu``, which K3
# and K4 share).
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()


def select_tiling(dtype: torch.dtype, shape: Sequence[int], *, bm: int = 128,
                  bn: int = 128, bk: int = 128, aligned: bool = True) -> str:
    """The tiling that ``bmm`` launches for a product of ``shape`` (B, M,
    K, N) in ``dtype`` at the deployed block sizes (see
    :func:`repro_torch.kernels.matmul_leakyrelu.gemm_tiling`)."""
    _, _, k, n = shape
    return gemm_tiling(dtype, k, n, bm, bn, bk, aligned)


def bmm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
        bk: int = 128) -> torch.Tensor:
    """a: (B, M, K), b: (B, K, N) -> a @ b (B, M, N) in a's type, with f32
    accumulation.  M, N and K must be multiples of the reference's block
    sizes, as the reference asserts.  On the card the instance of these
    block sizes runs (:func:`select_tiling`: the deployed config chooses
    the tiling): bf16 on wgmma, f32 on the SIMT instance of (bm, bn); rows
    neither takes run ``matmul_leakyrelu.SIMT``; ``launches_by_tiling``
    counts which ran (see ``csrc/gemm.cu``)."""
    global launches
    if a.ndim != 3 or b.ndim != 3 or b.shape[0] != a.shape[0]:
        raise ValueError(f"bmm: need a (B, M, K) and b (B, K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, m, k = a.shape
    _, k2, n = b.shape
    if not (k == k2 and m % bm == 0 and n % bn == 0 and k % bk == 0):
        raise AssertionError((tuple(a.shape), tuple(b.shape), bm, bn, bk))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.bmm(a, b)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"bmm: a on {a.device} and b on {b.device}; the "
                         f"kernel needs one CUDA device")
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"bmm: a and b must share f32 or bf16, got "
                        f"{a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bmm: a and b must be contiguous")
    out = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    tiling = select_tiling(a.dtype, (batch, m, k, n), bm=bm, bn=bn, bk=bk,
                           aligned=aligned16(a, b, out))
    launch_gemm("repro_bmm", a, b, out, (batch, m, k, n), tiling)
    launches += 1
    launches_by_tiling[tiling] += 1
    return out


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict) -> KernelSpec:
    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    return KernelSpec(
        name="bmm",
        tile_fn=lambda a, b: (a @ b,),
        inputs=[TileIO("a", (bm, bk)), TileIO("b", (bk, bn))],
        outputs=[TileIO("y", (bm, bn))],
        steps=3,
        accumulate=True,
        config=dict(cfg),
        flops_per_step=2 * bm * bn * bk,
    )


CONFIGS = [
    {"bm": 128, "bn": 128, "bk": 128},
    {"bm": 128, "bn": 128, "bk": 64},
    {"bm": 64, "bn": 64, "bk": 128},
    {"bm": 256, "bn": 64, "bk": 64},
]
