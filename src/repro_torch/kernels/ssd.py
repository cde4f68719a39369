"""Mamba-2 SSD chunk scan: the hand-written Hopper kernel
(``csrc/ssd.cu``) behind a checked wrapper, its gradient, and the
kernel's schedule spec for the optimizer.

Port of ``repro/kernels/ssd.py`` (the hot kernel of the mamba2 and zamba2
architectures), generalised to what the model calls through it
(``nn/ssm.py::apply_ssm``): the model layout x (B, S, H, P), a (B, S, H),
b and c (B, S, G, N) with G groups shared by H heads, and any S.  The
registry's flat layout x (BH, S, P), a (BH, S), b and c (BH, S, N) is its
one-head case.  The kernel's note in ``csrc/ssd.cu`` says what bounds it
on the card and what its design does about that.  On CPU tensors the
wrappers compute the plain version (:func:`repro_torch.kernels.ref.
ssd_chunk`); on CUDA tensors they launch the kernel or raise.

:class:`SSDFunction` is the differentiable form: its forward launches the
kernel, its backward differentiates the plain version, recomputed under
autograd from the saved inputs.  The JAX package differentiates the jnp
oracle with XLA's autodiff and has no backward kernel, so none is owed
here.

``make_spec`` / ``CONFIGS`` are the schedule optimizer's view of the
kernel (its steady-state tile loop and autotune space), as in the
reference; ``tile_fn`` is a torch function that
:mod:`repro_torch.sched.lowering` traces.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per call that
# launches the kernel's passes), in all and by the tiling that ran.
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()

MAX_P = MAX_N = 128     # the kernels' widest tiles

# The kernel instances compiled in csrc/ssd.cu, by id (its kTilings): the
# SIMT kernel (f32, and bf16 the wgmma route cannot take) in chunks of 64,
# then the bf16 wgmma instances by (chunk, P width, N width): one per
# CONFIGS entry.
SIMT = "simt_l64"
WGMMA = ((64, 64, 128), (128, 64, 128), (64, 128, 64))
TILINGS = (SIMT,) + tuple(f"wgmma_l{l}_p{p}_n{n}" for l, p, n in WGMMA)
# The chunk of a call that names none (the model's, through
# ops.ssd_chunk): 64 positions, the faster instance at mamba2-1.3b's
# training shape on the H100 (0.2558 ms of device time against chunk
# 128's 0.3776, PERF.md).
DEFAULT_CHUNK = 64
# Chunk lengths with an instance of their own; a shorter chunk that
# divides 64 (the reference test's 32) runs the 64-position instance
# (the chunked form is exact for any chunk length, and wgmma's tiles are
# 64 rows).
TILE_CHUNKS = (64, 128)


def tile_chunk(chunk: int) -> int:
    """The chunk length of the instance that a call naming ``chunk``
    runs; raises for a chunk with none."""
    if chunk in TILE_CHUNKS:
        return chunk
    if 0 < chunk < TILE_CHUNKS[0] and TILE_CHUNKS[0] % chunk == 0:
        return TILE_CHUNKS[0]
    raise ValueError(f"ssd: no kernel instance for chunk={chunk}; the "
                     f"instances run chunks of {TILE_CHUNKS} (a chunk "
                     f"dividing {TILE_CHUNKS[0]} runs {TILE_CHUNKS[0]}); "
                     f"compiled: {', '.join(TILINGS)}")


def select_tiling(dtype: torch.dtype, shape: Sequence[int], *,
                  chunk: Optional[int] = None, p: Optional[int] = None,
                  n: Optional[int] = None, aligned: bool = True) -> str:
    """The ``csrc/ssd.cu`` instance (a name of ``TILINGS``) that a call
    of ``shape`` (B, S, H, G, P, N) in ``dtype`` with the deployed
    ``chunk`` (``DEFAULT_CHUNK`` when None) launches; ``p`` and ``n``,
    where given, must be P and N.

    f32, and bf16 that the 16-byte copies cannot take (P or N not a
    multiple of 8, strides of x, b or c not multiples of 8 elements, or
    tensors not 16-byte aligned: ``aligned``) run ``SIMT`` in chunks of
    64 whatever chunk the call names (the chunked form is exact for any
    chunk length, and a 128-position f32 chunk does not fit a block's
    shared memory).  bf16 runs the first wgmma instance of the chunk's
    tile (``tile_chunk``) whose widths hold P and N: (64, 128) before
    (128, 64), so P 64 with N 64 runs the (64, 128) instance,
    zero-padded.  A bf16 chunk or widths with no compiled instance raise,
    listing the instances."""
    _, _, _, _, P, N = shape
    if (p is not None and p != P) or (n is not None and n != N):
        raise ValueError(f"ssd: the config's p={p}, n={n} are not the "
                         f"operands' P={P}, N={N}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd: the kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P={P}, N={N}")
    if dtype != torch.bfloat16 or P % 8 or N % 8 or not aligned:
        return SIMT
    length = tile_chunk(DEFAULT_CHUNK if chunk is None else chunk)
    for l, pw, nw in WGMMA:
        if l == length and P <= pw and N <= nw:
            return f"wgmma_l{l}_p{pw}_n{nw}"
    raise ValueError(f"ssd: no kernel instance for chunk={chunk}, P={P}, "
                     f"N={N} in bf16; compiled: {', '.join(TILINGS)}")


def segments(x: torch.Tensor, b: torch.Tensor, tiling: str,
             max_segments: int = 0) -> int:
    """The segments that ``csrc/ssd.cu`` cuts each head's sequence into
    for a call of ``tiling`` on x (B, S, H, P) and b (B, S, G, N) on the
    card: as many as fill one wave of the outputs kernel's resident
    blocks, none empty, at most ``max_segments`` (0: no cap)."""
    B, S, H, P = x.shape
    nseg = _build.library().repro_ssd_segments(
        B, S, H, b.shape[2], P, b.shape[3], max_segments,
        _build.tiling_ids("repro_ssd_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[x.dtype])
    _build.check(max(0, -nseg), f"ssd segments ({tiling})")
    return nseg


def _check_shapes(x, a, b, c, chunk):
    if x.ndim != 4 or b.ndim != 4 or c.shape != b.shape \
            or a.shape != x.shape[:3] or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd_chunk: need x (B, S, H, P), a (B, S, H) and "
                         f"b, c (B, S, G, N), got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if b.shape[2] == 0 or x.shape[2] % b.shape[2]:
        raise ValueError(f"ssd_chunk: H={x.shape[2]} is not a multiple of "
                         f"G={b.shape[2]}")
    if chunk < 1:
        raise ValueError(f"ssd_chunk: chunk must be >= 1, got {chunk}")


def _aligned(*tensors) -> bool:
    """Whether the 16-byte copies take these tensors: 16-byte-aligned
    bases and every stride but the last a multiple of 8 elements."""
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:-1])
               for t in tensors)


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
              max_segments: int = 0) -> torch.Tensor:
    """Model layout: x (B, S, H, P), a (B, S, H), b, c (B, S, G, N) ->
    y (B, S, H, P) in x's type.

    ``chunk`` blocks the plain version, and on the card chooses the
    instance (:func:`select_tiling`): bf16 runs the wgmma instance of
    chunk 64 or 128 (a chunk dividing 64 runs 64), f32 and what the
    16-byte copies cannot take the SIMT kernel in chunks of 64.  The
    chunked form is exact for any chunk length, so kernel and plain
    version differ only by f32 rounding (see ``csrc/ssd.cu``).  The
    kernel takes x, b and c in one of f32 and bf16, a in f32, P and N up
    to 128, any S and any strides whose last axis is contiguous;
    ``launches_by_tiling`` counts which instance ran.  ``max_segments``
    caps the segments of :func:`segments` (0: as many as fill the card)."""
    global launches
    _check_shapes(x, a, b, c, chunk)
    tensors = (x, a, b, c)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.ssd_chunk(x, a, b, c, chunk)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssd_chunk: the kernel needs x, a, b and c on one "
                         "CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if x.dtype not in _build.DTYPE_CODES or b.dtype != x.dtype \
            or c.dtype != x.dtype or a.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: x, b and c must share f32 or bf16 and "
                        f"a must be f32, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype} and {a.dtype}")
    if any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("ssd_chunk: the last axis of x, b and c must be "
                         "contiguous")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    tiling = select_tiling(x.dtype, (B, S, H, G, P, N), chunk=chunk,
                           aligned=_aligned(x, b, c))
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    nseg = segments(x, b, tiling, max_segments)
    work = None
    if nseg > 1:
        work = torch.empty((nseg - 1) * B * H * (P * N + 1),
                           dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.repro_ssd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(),
        B, S, H, G, P, N, *x.stride()[:3], *a.stride(), *b.stride()[:3],
        *c.stride()[:3], nseg,
        _build.tiling_ids("repro_ssd_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check(err, f"ssd_chunk ({tiling})")
    launches += 1
    launches_by_tiling[tiling] += 1
    return y


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = DEFAULT_CHUNK, p: Optional[int] = None,
        n: Optional[int] = None) -> torch.Tensor:
    """Flat layout (the registry's call): x (BH, S, P), a (BH, S), b, c
    (BH, S, N) -> (BH, S, P) in x's type.  S must be a multiple of
    ``chunk`` and a (BH, S), as the reference asserts; ``p`` and ``n`` are
    the widths a deployed config names and must be x's and b's; the
    deployed ``chunk`` chooses the instance (:func:`select_tiling`)."""
    BH, S, P = x.shape
    assert S % chunk == 0 and a.shape == (BH, S), \
        (tuple(x.shape), tuple(a.shape), chunk)
    if (p is not None and p != P) or (n is not None and n != b.shape[-1]):
        raise ValueError(f"ssd: the config's p={p}, n={n} are not the "
                         f"operands' P={P}, N={b.shape[-1]}")
    return ssd_chunk(x[:, :, None], a[:, :, None], b[:, :, None],
                     c[:, :, None], chunk=chunk)[:, :, 0]


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=(),
                         schema="(Tensor x, Tensor a, Tensor b, Tensor c, "
                                "int chunk) -> Tensor")
def ssd_chunk_op(x, a, b, c, chunk):
    """:func:`ssd_chunk` as an operator the dispatcher sees, the launch
    :class:`SSDFunction` makes: ``remat_policy="dots"`` names it
    (``ops.PRODUCTS``), so its output is saved and the recompute does not
    launch the kernel again."""
    return ssd_chunk(x, a, b, c, chunk=chunk)


class SSDFunction(torch.autograd.Function):
    """``ssd_chunk`` with gradients for x, a, b and c: the kernel forward
    (through :func:`ssd_chunk_op`), the plain version's gradient backward
    (recomputed from the saved inputs)."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        return ssd_chunk_op(x, a, b, c, chunk)

    @staticmethod
    def backward(ctx, grad_y):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ref.ssd_chunk(*leaves, ctx.chunk)
        return (*torch.autograd.grad(y, leaves, grad_y), None)


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict) -> KernelSpec:
    chunk, p, n = cfg["chunk"], cfg["p"], cfg["n"]

    def tile_fn(x, a, b, c):
        # per-chunk SSD: intra-chunk masked matmul + state contribution
        seg = torch.cumsum(a[:, 0], 0)
        scores = c @ b.T
        decay = torch.exp(seg[:, None] - seg[None, :])
        y_intra = (scores * decay) @ x
        state = (x * torch.exp(seg[-1] - seg)[:, None]).T @ b
        y_inter = torch.exp(seg)[:, None] * (c @ state.T)
        return (y_intra + y_inter,)

    return KernelSpec(
        name="ssd",
        tile_fn=tile_fn,
        inputs=[TileIO("x", (chunk, p)), TileIO("a", (chunk, 1)),
                TileIO("b", (chunk, n)), TileIO("c", (chunk, n))],
        outputs=[TileIO("y", (chunk, p))],
        steps=3,
        accumulate=False,
        config=dict(cfg),
        flops_per_step=2 * chunk * chunk * (n + p) + 4 * chunk * n * p,
    )


CONFIGS = [
    {"chunk": 64, "p": 64, "n": 128},
    {"chunk": 128, "p": 64, "n": 128},
    {"chunk": 64, "p": 128, "n": 64},
]
