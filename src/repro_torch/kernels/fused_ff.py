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

import collections
import functools
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch),
# in all and by the tiling that ran.
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()

# The kernel instances compiled in csrc/fused_ff.cu, by id (its kTilings):
# the SIMT kernel (what the others cannot take), the split-K decode
# kernels by the rows they hold, the bf16 wgmma instances by (bm, bn, bk):
# one per block shape of CONFIGS that the register file holds, and the f32
# SIMT instances by (bm, bn), likewise, with their K slab of 8.
SIMT = "simt_8x64"
GEMV_ROWS = (1, 2, 4, 8)
DECODE_ROWS = GEMV_ROWS[-1]       # M at or below this takes a gemv instance
WGMMA = ((128, 128, 128), (128, 128, 64), (64, 256, 64))
SIMT_F32 = ((128, 128), (64, 256))
SIMT_SLAB = 8
TILINGS = ((SIMT,) + tuple(f"gemv_m{r}" for r in GEMV_ROWS)
           + tuple(f"wgmma_bm{bm}_bn{bn}_bk{bk}" for bm, bn, bk in WGMMA)
           + tuple(f"simt_bm{bm}_bn{bn}_bk{SIMT_SLAB}" for bm, bn in SIMT_F32))
# (bm, bn, bk) for calls that name none (the model's)
DEFAULT_BLOCK = (128, 128, 64)
# block shapes that run another's instance: (256, 128, 64) would hold two
# 256 x 128 f32 accumulators, the whole register file (in f32 on the CUDA
# cores, 256 a thread), so it runs as two 128-row tiles one after another
# (csrc/fused_ff.cu)
SHARED_BLOCKS = {(256, 128, 64): (128, 128, 64)}


@functools.lru_cache(maxsize=1024)
def select_tiling(dtype: torch.dtype, shape: Sequence[int], *,
                  bm: Optional[int] = None, bn: Optional[int] = None,
                  bk: Optional[int] = None, aligned: bool = True) -> str:
    """The ``csrc/fused_ff.cu`` instance (a name of ``TILINGS``) that
    ``fused_ff`` launches for a product of ``shape`` (M, K, N) in ``dtype``
    at the deployed block sizes.

    M <= ``DECODE_ROWS``: the gemv instance of the fewest rows that hold M,
    in either dtype, if N is a multiple of the 16-byte vector and the
    tensors are 16-byte aligned (``aligned``); else ``SIMT``.  Above it,
    the block (bm, bn, bk), each None taken from ``DEFAULT_BLOCK``, with
    (256, 128, 64) on the (128, 128, 64) instance (``SHARED_BLOCKS``):
    bf16 runs its wgmma instance, f32 the SIMT instance of (bm, bn) with a
    K slab of 8 (bk does not change it); bf16 rows TMA cannot take (K or N
    not a multiple of 8) and f32 rows the 4-element loads cannot take (K
    or N not a multiple of 4), or unaligned tensors, run ``SIMT``.  A
    block shape with no compiled instance raises, listing the
    instances."""
    m, k, n = shape
    if m <= DECODE_ROWS:
        if aligned and n % (16 // dtype.itemsize) == 0:
            return f"gemv_m{next(r for r in GEMV_ROWS if m <= r)}"
        return SIMT
    vec = 8 if dtype == torch.bfloat16 else 4
    if k == 0 or k % vec or n % vec or not aligned:
        return SIMT
    block = tuple(d if b is None else b
                  for b, d in zip((bm, bn, bk), DEFAULT_BLOCK))
    bm, bn, bk = SHARED_BLOCKS.get(block, block)
    name = (f"wgmma_bm{bm}_bn{bn}_bk{bk}" if dtype == torch.bfloat16
            else f"simt_bm{bm}_bn{bn}_bk{SIMT_SLAB}")
    if name not in TILINGS:
        raise ValueError(f"fused_ff: no kernel instance {name} for "
                         f"bm={block[0]}, bn={block[1]}, bk={block[2]} in "
                         f"{dtype}; compiled: {', '.join(TILINGS)}")
    return name


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_splits(k: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """The most slices of K a gemv call may take (its workspace holds
    their partial sums): enough for a grid (a block per 16 vectors of each
    weight's columns, by slice) of four blocks an SM on ``sms`` SMs, and
    no slice shorter than 64 rows.  The kernel takes as many of them as
    one wave of the card holds (``csrc/fused_ff.cu``)."""
    blocks = -(-n // (16 * (16 // dtype.itemsize)))
    return max(1, min(-(-4 * sms // blocks), -(-k // 64)))


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
             bm: Optional[int] = None, bn: Optional[int] = None,
             bk: Optional[int] = None) -> torch.Tensor:
    """x: (M, K); w_gate, w_up: (K, N) -> (M, N) in x's type.

    ``bm``/``bn``/``bk`` are the reference's block sizes: M, N and K must
    be multiples of those given, as the reference asserts.  On the card
    the instance :func:`select_tiling` names runs, and
    ``launches_by_tiling`` counts which ran (see ``csrc/fused_ff.cu``)."""
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
    device = x.device
    devices = (device, w_gate.device, w_up.device)
    if all(d.type == "cpu" for d in devices):
        return ref.fused_ff(x, w_gate, w_up)
    if device.type != "cuda" or devices.count(device) != 3:
        raise ValueError("fused_ff: the kernel needs all three tensors on "
                         "one CUDA device, got "
                         + ", ".join(map(str, devices)))
    dtype = x.dtype
    if dtype not in _build.DTYPE_CODES \
            or w_gate.dtype != dtype or w_up.dtype != dtype:
        raise TypeError(f"fused_ff: x and both weights must share f32 or "
                        f"bf16, got {dtype}, {w_gate.dtype}, {w_up.dtype}")
    if not (x.is_contiguous() and w_gate.is_contiguous()
            and w_up.is_contiguous()):
        raise ValueError("fused_ff: x and both weights must be contiguous")
    out = torch.empty((M, N), dtype=dtype, device=device)
    ptrs = x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr()
    tiling = select_tiling(dtype, (M, K, N), bm=bm, bn=bn, bk=bk,
                           aligned=(ptrs[0] | ptrs[1] | ptrs[2]
                                    | ptrs[3]) % 16 == 0)
    splits, work = 1, None
    if tiling.startswith("gemv_"):
        splits = gemv_splits(K, N, dtype, _sm_count(device.index))
        work = torch.empty(2 * splits * M * N, dtype=torch.float32,
                           device=device)
    err = _build.library().repro_fused_ff(
        *ptrs, None if work is None else work.data_ptr(), M, K, N, splits,
        _build.tiling_ids("repro_fused_ff_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[dtype], _build.stream_handle(device))
    _build.check(err, f"fused_ff ({tiling})")
    launches += 1
    launches_by_tiling[tiling] += 1
    return out


@torch.library.custom_op("repro_torch::fused_ff", mutates_args=(),
                         schema="(Tensor x, Tensor w_gate, Tensor w_up) "
                                "-> Tensor")
def fused_ff_op(x, w_gate, w_up):
    """:func:`fused_ff` as an operator the dispatcher sees, the launch
    :class:`FusedFFFunction` makes: ``remat_policy="dots"`` names it
    (``ops.PRODUCTS``), so its output is saved and the recompute does not
    launch the kernel again."""
    return fused_ff(x, w_gate, w_up)


class FusedFFFunction(torch.autograd.Function):
    """``fused_ff`` with gradients for x, Wg and Wu: the kernel forward
    (through :func:`fused_ff_op`), the plain version's gradient
    backward."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return fused_ff_op(x, w_gate, w_up)

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
