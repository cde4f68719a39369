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

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0

MAX_P = MAX_N = 128     # the kernel's register tiles


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


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Model layout: x (B, S, H, P), a (B, S, H), b, c (B, S, G, N) ->
    y (B, S, H, P) in x's type.

    ``chunk`` blocks the plain version; the CUDA kernel stages chunks of
    its own length (64) whatever ``chunk`` says: the chunked form is
    exact for any chunk length, so the two differ only by f32 rounding
    (see ``csrc/ssd.cu``).  The kernel takes x, b and c in one of f32 and
    bf16, a in f32, P and N up to 128, any S and any strides whose last
    axis is contiguous."""
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
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_chunk: the kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P={P}, N={N}")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.repro_ssd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        B, S, H, G, P, N, *x.stride()[:3], *a.stride(), *b.stride()[:3],
        *c.stride()[:3], _build.DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device))
    _build.check(err, "ssd_chunk")
    launches += 1
    return y


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 64, p: Optional[int] = None,
        n: Optional[int] = None) -> torch.Tensor:
    """Flat layout (the registry's call): x (BH, S, P), a (BH, S), b, c
    (BH, S, N) -> (BH, S, P) in x's type.  S must be a multiple of
    ``chunk`` and a (BH, S), as the reference asserts; ``p`` and ``n`` are
    the widths a deployed config names and must be x's and b's."""
    BH, S, P = x.shape
    assert S % chunk == 0 and a.shape == (BH, S), \
        (tuple(x.shape), tuple(a.shape), chunk)
    if (p is not None and p != P) or (n is not None and n != b.shape[-1]):
        raise ValueError(f"ssd: the config's p={p}, n={n} are not the "
                         f"operands' P={P}, N={b.shape[-1]}")
    return ssd_chunk(x[:, :, None], a[:, :, None], b[:, :, None],
                     c[:, :, None], chunk=chunk)[:, :, 0]


class SSDFunction(torch.autograd.Function):
    """``ssd_chunk`` with gradients for x, a, b and c: the kernel forward,
    the plain version's gradient backward (recomputed from the saved
    inputs)."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        return ssd_chunk(x, a, b, c, chunk=chunk)

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
