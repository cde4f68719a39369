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

from typing import Dict

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0


def bmm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
        bk: int = 128) -> torch.Tensor:
    """a: (B, M, K), b: (B, K, N) -> a @ b (B, M, N) in a's type, with f32
    accumulation.  M, N and K must be multiples of the reference's block
    sizes, as the reference asserts; the CUDA kernel's own tiling does not
    depend on them (see ``csrc/gemm.cu``)."""
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
    err = _build.library().repro_bmm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, k, n,
        _build.DTYPE_CODES[a.dtype], _build.stream_handle(a.device))
    _build.check(err, "bmm")
    launches += 1
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
