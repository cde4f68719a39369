"""Attention with an online softmax: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) behind a checked wrapper, its gradient, and
the kernel's schedule spec for the optimizer.

Port of ``repro/kernels/flash_attention.py`` (paper Table 2
"flash-attention"), generalised to what the model calls through it
(``nn.attention.chunked_attention``): grouped KV heads, a sliding window
and a query offset.  The kernel's note in ``csrc/flash_attention.cu`` says
what bounds it on the card and what its design does about that.  On CPU
tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.flash_attention`); on CUDA tensors it
launches the kernel or raises.

:class:`FlashAttentionFunction` is the differentiable form: its forward
launches the kernel, which under grad also writes each query row's
log-sum-exp; its backward, for bf16 CUDA tensors that TMA takes, is the
hand-written backward kernel (``csrc/flash_attention_bwd.cu``: the
FlashAttention-2/3 gradient from q, k, v, the output and that
log-sum-exp, S x S never formed), and otherwise (f32, unaligned bf16,
CPU tensors) the plain version's gradient, recomputed under autograd
from the saved q, k and v one batch row and a bounded group of KV heads
at a time (:func:`flash_attention_backward`, also the kernel's oracle).
The JAX package differentiates its jnp attention with XLA's autodiff and
has no backward kernel.

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
from repro_torch.sched.spec import KernelSpec, TileIO

# Kernel launches made by this process (the wrapper adds one per launch),
# in all and by the tiling that ran; the same of the backward kernel, and
# the backward calls that took the plain version.
launches = 0
launches_by_tiling: collections.Counter = collections.Counter()
backward_launches = 0
backward_launches_by_tiling: collections.Counter = collections.Counter()
plain_backward_calls = 0

# The kernel instances compiled in csrc/flash_attention.cu, by id (its
# kTilings): the SIMT kernel at 64 x 64 (f32 calls that name no config, and
# bf16 that TMA cannot take), the bf16 wgmma instances by (bq, bk,
# head-dim width): one per CONFIGS entry, and the training path's default
# at stablelm-3b's D = 80; then the f32 SIMT instances by the tile they
# run: one per CONFIGS entry, after fitting (``f32_block``); then MLA's
# head dims (q and k 192, v 128: deepseek-v2-lite) at the default tile, in
# bf16 on wgmma and in f32 on the SIMT kernel.
SIMT = "simt_64x64"
WGMMA = ((128, 128, 64), (128, 256, 64), (256, 128, 64), (128, 128, 80),
         (128, 128, 128))
SIMT_F32 = ((128, 128, 64), (256, 64, 64), (128, 64, 128))
MLA_WGMMA, MLA_SIMT = "wgmma_bq128_bk128_d192_v128", "simt_bq64_bk64_d192_v128"
TILINGS = ((SIMT,) + tuple(f"wgmma_bq{bq}_bk{bk}_d{w}" for bq, bk, w in WGMMA)
           + tuple(f"simt_bq{bq}_bk{bk}_d{w}" for bq, bk, w in SIMT_F32)
           + (MLA_WGMMA, MLA_SIMT))
# The tiling of a call that names no bq / bk (the model's call through
# nn.attention.chunked_attention): 128 query rows, 128 keys a tile.
DEFAULT_BQ = DEFAULT_BK = 128
# (q/k, v) head-dim widths of the instances: a call runs on the first
# pair that holds its (D, Dv) (the paper's 32 on 64, zero-filled by TMA)
_WIDTHS = ((64, 64), (80, 80), (128, 128), (192, 128))
# shared memory a block may have (the f32 tile's q, K^T, V and P)
_SMEM_BYTES = 227 * 1024
# The backward kernel's instances (csrc/flash_attention_bwd.cu's
# kTilings): one per width pair of ``_WIDTHS``, each block 128 keys
# against stages of 64 query rows.
BACKWARD_TILINGS = tuple(f"wgmma_bk128_bq64_d{wq}" + ("" if wq == wv
                                                      else f"_v{wv}")
                         for wq, wv in _WIDTHS)
# Rows of the log-sum-exp a head holds: Sq rounded up to this
# (csrc/common.cuh: kRowPad), so the backward copies whole tiles of it.
ROW_PAD = 64


def f32_block(bq: int, bk: int, width: int):
    """The f32 SIMT tile that a deployed (bq, bk) runs at head-dim width
    ``width``: the config's own where its q, K^T, V and P tiles in f32 fit
    a block's shared memory, else bk halved, then bq, until they do:
    (128, 256, 64) runs (128, 128), (256, 128, 64) runs (256, 64) and
    (128, 128, 128) runs (128, 64)."""
    def smem(q, k):
        return 4 * (q * (width + 4) + width * (k + 1) + k * width
                    + q * (k + 4))
    while smem(bq, bk) > _SMEM_BYTES and bk > 16:
        bk //= 2
    while smem(bq, bk) > _SMEM_BYTES and bq > 16:
        bq //= 2
    return bq, bk

# (query heads x Sq x Sk) f32 entries per recompute in the backward: each
# of the plain version's (heads, Sq, Sk) tensors stays under 512 MB.
_BACKWARD_ENTRIES = 1 << 27


def _check_shapes(q, k, v, window, q_offset):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or v.shape[:3] != k.shape[:3] or v.shape[-1] == 0 \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention: need q (B, H, Sq, D), k (B, KH, "
                         f"Sk, D) and v (B, KH, Sk, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: H={q.shape[1]} is not a "
                         f"multiple of KH={k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if window < 1 or q_offset < 0:
        raise ValueError(f"flash_attention: need window >= 1 and q_offset "
                         f">= 0, got {window} and {q_offset}")


def _no_instance(what: str) -> ValueError:
    return ValueError(f"flash_attention: no kernel instance {what}; "
                      f"compiled: {', '.join(TILINGS)}")


def select_tiling(dtype: torch.dtype, q_shape: Sequence[int], *,
                  bq: Optional[int] = None, bk: Optional[int] = None,
                  d: Optional[int] = None, dv: Optional[int] = None,
                  aligned: bool = True) -> str:
    """The kernel instance (a name of ``TILINGS``) that a call with q of
    ``q_shape`` (B, H, Sq, D), v of head dim ``dv`` (None: D) in
    ``dtype`` and the deployed keywords launches.  The head dims run at
    the first (q/k, v) width pair of ``_WIDTHS`` that holds (D, Dv).
    bf16 runs the wgmma instance of (``bq``, ``bk``, those widths), with
    ``DEFAULT_BQ`` / ``DEFAULT_BK`` for keywords that are None; a head
    dim that is not a multiple of 8, or tensors not 16-byte aligned
    (``aligned``), run ``SIMT``.  f32 runs ``SIMT`` for a call that names
    neither bq nor bk (the model's), else the SIMT instance of the tile
    :func:`f32_block` fits to the config.  MLA's widths (192, 128) have
    the default tile only: ``MLA_WGMMA`` in bf16, ``MLA_SIMT`` in f32.  A
    call with no compiled instance raises, listing the instances."""
    D = q_shape[-1]
    Dv = D if dv is None else dv
    if d is not None and d != D:
        raise ValueError(f"flash_attention: the config's d={d} is not the "
                         f"head dim {D}")
    widths = next(((wq, wv) for wq, wv in _WIDTHS if D <= wq and Dv <= wv),
                  None)
    if widths is None:
        raise _no_instance(f"holds head dims D={D}, Dv={Dv}")
    bq_, bk_ = (DEFAULT_BQ if bq is None else bq,
                DEFAULT_BK if bk is None else bk)
    simt_ok = widths[0] == widths[1]       # SIMT at 64 x 64 and D = Dv
    if dtype == torch.bfloat16 and (D % 8 or Dv % 8 or not aligned):
        if not simt_ok:
            raise _no_instance(f"takes D={D}, Dv={Dv} in bf16 where TMA "
                               f"cannot (unaligned, or not a multiple of 8)")
        return SIMT
    if dtype == torch.bfloat16:
        name = f"wgmma_bq{bq_}_bk{bk_}_d{widths[0]}"
    elif bq is None and bk is None:
        if simt_ok:
            return SIMT
        name = f"simt_bq64_bk64_d{widths[0]}"
    else:
        fq, fk = f32_block(bq_, bk_, widths[0])
        name = f"simt_bq{fq}_bk{fk}_d{widths[0]}"
    if not simt_ok:
        name += f"_v{widths[1]}"
    if name not in TILINGS:
        raise _no_instance(f"{name} for bq={bq}, bk={bk}, D={D}, Dv={Dv} in "
                           f"{dtype}")
    return name


def select_backward_tiling(dtype: torch.dtype, q_shape: Sequence[int], *,
                           dv: Optional[int] = None,
                           aligned: bool = True) -> Optional[str]:
    """The backward kernel's instance (a name of ``BACKWARD_TILINGS``) for
    a call with q of ``q_shape`` (B, H, Sq, D) and v of head dim ``dv``
    (None: D) in ``dtype``: the first (q/k, v) width pair of ``_WIDTHS``
    that holds (D, Dv), in bf16 with 16-byte aligned tensors
    (``aligned``) and head dims that are multiples of 8, the calls whose
    forward runs a wgmma instance.  None for every other call (f32, and
    bf16 that TMA cannot take): its gradient is the plain version's."""
    D = q_shape[-1]
    Dv = D if dv is None else dv
    if dtype != torch.bfloat16 or D % 8 or Dv % 8 or not aligned:
        return None
    for wq, wv in _WIDTHS:
        if D <= wq and Dv <= wv:
            return BACKWARD_TILINGS[_WIDTHS.index((wq, wv))]
    return None


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _backward_tiling(q, k, v) -> Optional[str]:
    """The backward instance the Function's gradient of (q, k, v) runs,
    None where it takes the plain version (any tensor off the card)."""
    if not all(t.is_cuda for t in (q, k, v)):
        return None
    return select_backward_tiling(q.dtype, q.shape, dv=v.shape[-1],
                                  aligned=_aligned(q, k, v))


def _padded_rows(sq: int) -> int:
    return -(-sq // ROW_PAD) * ROW_PAD


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = ref.NO_WINDOW,
                    q_offset: int = 0, scale: float = None,
                    bq: Optional[int] = None, bk: Optional[int] = None,
                    d: Optional[int] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, KH, Sk, D); v: (B, KH, Sk, Dv) ->
    (B, H, Sq, Dv) in q's type.  Dv may differ from D (MLA: 192 and 128)
    where an instance holds the pair (:func:`select_tiling`).

    ``bq``/``bk`` are the reference's query and key block sizes: Sq and
    Sk must be multiples of those given, as the reference asserts.  ``d``
    is the head dim a deployed config names; it must equal D.  On the
    card the instance that :func:`select_tiling` names for them runs (so
    the deployed config chooses the tiling): bf16 on wgmma, f32 on the
    SIMT instance of the config's fitted tile, or ``SIMT`` for a call that
    names none; ``launches_by_tiling`` counts which ran (see
    ``csrc/flash_attention.cu``).

    ``lse``, where given (the Function's forward under grad), is an f32
    (B, H, Sq rounded up to ``ROW_PAD``) buffer on q's device that the
    kernel fills with each row's log-sum-exp, in the base-2 units of its
    softmax (p = 2^(s * scale * log2 e - lse)); only wgmma instances
    write it.  Calls that pass none write nothing extra."""
    global launches
    _check_shapes(q, k, v, window, q_offset)
    if (bq is not None and q.shape[2] % bq) \
            or (bk is not None and k.shape[2] % bk):
        raise AssertionError((tuple(q.shape), tuple(k.shape), bq, bk))
    if d is not None and d != q.shape[-1]:
        raise ValueError(f"flash_attention: the config's d={d} is not the "
                         f"head dim {q.shape[-1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("flash_attention: the kernel needs q, k and v on "
                         "one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if q.dtype not in _build.DTYPE_CODES \
            or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_attention: q, k and v must share f32 or "
                        "bf16, got " + ", ".join(str(t.dtype)
                                                 for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if B * H > 65535:
        raise ValueError(f"flash_attention: the kernel takes B*H <= 65535, "
                         f"got B*H={B * H}")
    tiling = select_tiling(q.dtype, q.shape, bq=bq, bk=bk, d=d, dv=Dv,
                           aligned=_aligned(*tensors))
    if lse is not None and (
            not tiling.startswith("wgmma_") or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()
            or tuple(lse.shape) != (B, H, _padded_rows(Sq))):
        raise ValueError(f"flash_attention: lse must be an f32 (B, H, Sq "
                         f"padded to {ROW_PAD}) buffer on q's device, for a "
                         f"wgmma instance; got {tuple(lse.shape)} "
                         f"{lse.dtype} for {tiling}")
    out = q.new_empty((B, H, Sq, Dv))
    lib = _build.library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), B, H, KH,
        Sq, Sk, D, Dv, float(scale), int(bool(causal)),
        int(min(window, 2 ** 31 - 1)), int(q_offset),
        _build.tiling_ids("repro_flash_attention_tilings", TILINGS)[tiling],
        _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device))
    _build.check(err, f"flash_attention ({tiling})")
    launches += 1
    launches_by_tiling[tiling] += 1
    return out


def flash_attention_backward(q, k, v, grad_out, *, causal, window, q_offset,
                             scale):
    """(dq, dk, dv) of the plain version at (q, k, v), by autograd through
    it, one batch row and a group of KV heads at a time (so the plain
    version's (heads, Sq, Sk) f32 tensors stay bounded)."""
    B, H, Sq, _ = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    step = max(1, _BACKWARD_ENTRIES // max(1, G * Sq * Sk))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for b in range(B):
        for h0 in range(0, KH, step):
            h1 = min(KH, h0 + step)
            qs = q[b:b + 1, h0 * G:h1 * G].detach().requires_grad_()
            ks = k[b:b + 1, h0:h1].detach().requires_grad_()
            vs = v[b:b + 1, h0:h1].detach().requires_grad_()
            with torch.enable_grad():
                o = ref.flash_attention(qs, ks, vs, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale)
            gq, gk, gv = torch.autograd.grad(
                o, (qs, ks, vs), grad_out[b:b + 1, h0 * G:h1 * G])
            dq[b:b + 1, h0 * G:h1 * G] = gq
            dk[b:b + 1, h0:h1] = gk
            dv[b:b + 1, h0:h1] = gv
    return dq, dk, dv


def flash_attention_grad(q, k, v, out, lse, grad_out, *, causal, window,
                         q_offset, scale):
    """(dq, dk, dv) of attention at (q, k, v) by the backward kernel, from
    the forward's ``out`` and ``lse`` (:func:`flash_attention`'s) and the
    output's gradient ``grad_out``, in q's type; the instance
    :func:`select_backward_tiling` names runs, and
    ``backward_launches_by_tiling`` counts it.  Calls that no instance
    takes (CPU tensors, f32, unaligned bf16) raise: their gradient is
    :func:`flash_attention_backward`'s, which the Function calls itself."""
    global backward_launches
    _check_shapes(q, k, v, window, q_offset)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    tensors = (q, k, v, out, grad_out)
    tiling = _backward_tiling(q, k, v)
    if tiling is None or not (
            all(t.device == q.device and t.dtype == q.dtype
                and t.is_contiguous() for t in tensors)
            and _aligned(*tensors) and tuple(out.shape) == (B, H, Sq, Dv)
            and tuple(grad_out.shape) == (B, H, Sq, Dv)
            and lse.dtype == torch.float32 and lse.device == q.device
            and tuple(lse.shape) == (B, H, _padded_rows(Sq))):
        raise ValueError(
            f"flash_attention_grad: no backward instance takes q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, out {tuple(out.shape)}, grad_out "
            f"{tuple(grad_out.shape)}, lse {tuple(lse.shape)} on "
            f"{q.device}; compiled: {', '.join(BACKWARD_TILINGS)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_acc = q.new_empty((B, H, Sq, D), dtype=torch.float32)
    delta = q.new_empty((B, H, _padded_rows(Sq)), dtype=torch.float32)
    err = _build.library().repro_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(), B, H, KH, Sq,
        Sk, D, Dv, float(scale), int(bool(causal)),
        int(min(window, 2 ** 31 - 1)), int(q_offset),
        _build.tiling_ids("repro_flash_attention_backward_tilings",
                          BACKWARD_TILINGS)[tiling],
        _build.stream_handle(q.device))
    _build.check(err, f"flash_attention backward ({tiling})")
    backward_launches += 1
    backward_launches_by_tiling[tiling] += 1
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, "
                                "int window, int q_offset, float? scale) "
                                "-> (Tensor, Tensor)")
def flash_attention_op(q, k, v, causal, window, q_offset, scale):
    """:func:`flash_attention` as an operator the dispatcher sees, the
    launch :class:`FlashAttentionFunction` makes: ``remat_policy="dots"``
    names it (``ops.PRODUCTS``), so its outputs are saved and the
    recompute does not launch the kernel again.  Every K6 forward the
    port makes, with or without a gradient to take, is a call of this
    operator.  Returns (out, lse): the rows' log-sum-exp where a gradient
    will be taken (q, k or v requires one: the Function's forward under
    grad) and the backward kernel will take it (:func:`_backward_tiling`),
    else an empty tensor, and the kernel writes none (serving,
    evaluation)."""
    lse = None
    if any(t.requires_grad for t in (q, k, v)) \
            and _backward_tiling(q, k, v) is not None:
        lse = q.new_empty((q.shape[0], q.shape[1], _padded_rows(q.shape[2])),
                          dtype=torch.float32)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, scale=scale, lse=lse)
    return out, (q.new_empty((0,), dtype=torch.float32) if lse is None
                 else lse)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor out, "
                                "Tensor lse, Tensor grad_out, bool causal, "
                                "int window, int q_offset, float? scale) "
                                "-> (Tensor, Tensor, Tensor)")
def flash_attention_backward_op(q, k, v, out, lse, grad_out, causal, window,
                                q_offset, scale):
    """:func:`flash_attention_grad` as an operator the dispatcher (and a
    profiler's trace) sees: the backward kernel's launch."""
    return flash_attention_grad(q, k, v, out, lse, grad_out, causal=causal,
                                window=window, q_offset=q_offset,
                                scale=scale)


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with a gradient: the kernel forward (through
    :func:`flash_attention_op`, which writes the log-sum-exp the backward
    kernel needs), and as the backward the kernel (through
    :func:`flash_attention_backward_op`) where
    :func:`select_backward_tiling` names an instance, else the plain
    version's gradient recomputed from the saved inputs
    (``plain_backward_calls`` counts those).  The forward saves the
    output and the log-sum-exp only where the operator wrote one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        out, lse = flash_attention_op(q, k, v, **ctx.args)
        ctx.save_for_backward(q, k, v, *((out, lse) if lse.numel() else ()))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        global plain_backward_calls
        saved = ctx.saved_tensors
        q, k, v = saved[:3]
        if len(saved) == 3:
            plain_backward_calls += 1
            dq, dk, dv = flash_attention_backward(q, k, v, grad_out,
                                                  **ctx.args)
        else:
            out, lse = saved[3:]
            grad_out = grad_out.contiguous()
            if not _aligned(grad_out):
                grad_out = grad_out.clone()
            dq, dk, dv = flash_attention_backward_op(q, k, v, out, lse,
                                                     grad_out, **ctx.args)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# schedule-optimizer integration
# ---------------------------------------------------------------------------

def make_spec(cfg: Dict) -> KernelSpec:
    bq, bk, d = cfg["bq"], cfg["bk"], cfg["d"]

    def tile_fn(q, k, v):
        s = q @ k.T
        m = torch.amax(s, -1, keepdim=True)
        p = torch.exp(s - m)
        ell = torch.sum(p, -1, keepdim=True)
        return (p @ v, ell)

    def epilogue_fn(acc, ell):
        return (acc / ell,)

    return KernelSpec(
        name="flash_attention",
        tile_fn=tile_fn,
        epilogue_fn=epilogue_fn,
        inputs=[TileIO("q", (bq, d), invariant=True),
                TileIO("k", (bk, d)), TileIO("v", (bk, d))],
        outputs=[TileIO("o", (bq, d))],
        steps=3,
        accumulate=True,
        config=dict(cfg),
        flops_per_step=4 * bq * bk * d,
    )


# paper configuration: B=1, n_head=4, seq=4096, d_head=32 (+ larger heads)
CONFIGS = [
    {"bq": 128, "bk": 128, "d": 64},
    {"bq": 128, "bk": 256, "d": 64},
    {"bq": 256, "bk": 128, "d": 64},
    {"bq": 128, "bk": 128, "d": 128},
]
