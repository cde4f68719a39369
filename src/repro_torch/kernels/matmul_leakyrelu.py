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

import collections
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.scenario import Scenario, scenario_steps
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch),
# in all and by the tiling that ran.
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()

# The kernel instances compiled in csrc/gemm.cu (K3 and K4 share it), by id
# (its kTilings): the SIMT kernel for what the other routes cannot take
# (f32 or bf16 rows that the 4-element loads or TMA cannot take), the bf16
# wgmma instances by (bm, bn, bk): one per CONFIGS entry of this module and
# of ``bmm``, and the two block shapes ``tests/test_kernels.py``'s cases
# name, (64, 128, 64) and (64, 64, 64); then the f32 SIMT instances by
# (bm, bn): one per block shape of those configs, each with the K slab of
# 8 whatever bk names (csrc/gemm.cu).
SIMT = "simt_128x128x8"
WGMMA = ((128, 128, 128), (128, 128, 64), (64, 128, 128), (128, 256, 64),
         (256, 128, 64), (64, 64, 128), (256, 64, 64), (64, 128, 64),
         (64, 64, 64))
SIMT_F32 = ((128, 128), (64, 128), (128, 256), (256, 128), (64, 64),
            (256, 64))
SIMT_SLAB = 8
TILINGS = ((SIMT,) + tuple(f"wgmma_bm{bm}_bn{bn}_bk{bk}"
                           for bm, bn, bk in WGMMA)
           + tuple(f"simt_bm{bm}_bn{bn}_bk{SIMT_SLAB}" for bm, bn in SIMT_F32))


def gemm_tiling(dtype: torch.dtype, k: int, n: int, bm: int, bn: int,
                bk: int, aligned: bool = True) -> str:
    """The ``csrc/gemm.cu`` instance (a name of ``TILINGS``) of a product
    with inner size ``k`` and ``n`` columns at the block sizes ``bm``,
    ``bn``, ``bk``.  bf16: the wgmma instance of (bm, bn, bk), or ``SIMT``
    for rows TMA cannot take (K or N not a multiple of 8, or tensors not
    16-byte aligned: ``aligned``).  f32: the SIMT instance of (bm, bn) with
    its K slab of 8 (bk does not change it), or ``SIMT`` for rows the
    4-element loads cannot take (K or N not a multiple of 4, or
    unaligned).  A block shape with no compiled instance raises, listing
    the instances."""
    if dtype == torch.bfloat16:
        if k == 0 or k % 8 or n % 8 or not aligned:
            return SIMT
        name = f"wgmma_bm{bm}_bn{bn}_bk{bk}"
    else:
        if k == 0 or k % 4 or n % 4 or not aligned:
            return SIMT
        name = f"simt_bm{bm}_bn{bn}_bk{SIMT_SLAB}"
    if name not in TILINGS:
        raise ValueError(f"gemm: no kernel instance {name} for bm={bm}, "
                         f"bn={bn}, bk={bk} in {dtype}; compiled: "
                         f"{', '.join(TILINGS)}")
    return name


def select_tiling(dtype: torch.dtype, shape: Sequence[int], *, bm: int = 128,
                  bn: int = 128, bk: int = 128, aligned: bool = True) -> str:
    """The tiling that ``matmul_leakyrelu`` launches for a product of
    ``shape`` (M, K, N) in ``dtype`` at the deployed block sizes."""
    _, k, n = shape
    return gemm_tiling(dtype, k, n, bm, bn, bk, aligned)


def launch_gemm(symbol: str, a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor, dims: Sequence, tiling: str) -> None:
    """Launch ``symbol`` of ``csrc/gemm.cu`` (``repro_matmul_leakyrelu`` or
    ``repro_bmm``) with its size arguments ``dims`` and the kernel
    instance ``tiling``."""
    lib = _build.library()
    err = getattr(lib, symbol)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), *dims,
        _build.tiling_ids("repro_gemm_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[a.dtype], _build.stream_handle(a.device))
    _build.check(err, f"{symbol} ({tiling})")


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def matmul_leakyrelu(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                     bn: int = 128, bk: int = 128,
                     negative_slope: float = 0.01) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> LeakyReLU(a @ b) (M, N) in a's type.

    ``bm``/``bn``/``bk`` are the reference's block sizes: M, N and K must
    be multiples of them, as the reference asserts.  On the card the
    instance of these block sizes runs (:func:`select_tiling`: the
    deployed config chooses the tiling): bf16 on wgmma, f32 on the SIMT
    instance of (bm, bn); rows neither takes run ``SIMT``;
    ``launches_by_tiling`` counts which ran (see ``csrc/gemm.cu``)."""
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
    tiling = select_tiling(a.dtype, (m, k, n), bm=bm, bn=bn, bk=bk,
                           aligned=aligned16(a, b, out))
    launch_gemm("repro_matmul_leakyrelu", a, b, out,
                (m, k, n, float(negative_slope)), tiling)
    launches += 1
    launches_by_tiling[tiling] += 1
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
