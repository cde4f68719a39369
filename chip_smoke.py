#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py                  # the seven phases below
    python3 chip_smoke.py --profile DIR    # also: torch.profiler
                                           # breakdowns of decode passes
                                           # and of a train step, in DIR

Phases, each printed on lines of its own:

1. card — ``nvidia-smi`` name and power limit; build the kernel library
   from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and time it;
2. kernels — each hand-written kernel against its plain PyTorch version
   on the card: K1 ``rmsnorm`` and K2 ``fused_ff`` in bf16 and f32 at the
   serving path's shapes and a ragged one, and in bf16 at the training
   path's (8192 rows); K6 ``flash_attention`` in f32 and bf16 at the
   training path's shape, a ragged GQA shape with a window, a non-causal
   shape and a query offset; K3 ``matmul_leakyrelu`` and K4 ``bmm`` in f32
   and bf16 at ``tests/test_kernels.py``'s shapes, a ragged shape and the
   optimizer path's shapes; the gradients of the three model kernels'
   ``autograd.Function``s against autograd through the plain versions at
   the training shapes; CUDA-event times of each kernel, its plain version
   and a library yardstick beside its bound;
3. device against host — full-width qwen1.5-4b cut to 2 layers, f32:
   decode logits agree; full-width stablelm-3b cut to 2 layers, f32: one
   train step's loss and grad-norm agree (the grad-norm within a bound
   set by the host's own f32 error against an f64 evaluation);
4. serving main path — qwen1.5-4b at full width, bf16, seeded random
   weights, 16 loadgen requests from 2 tenants through the paged
   ``ServeEngine`` (8 lanes); every request completes with in-vocab
   tokens, and the kernels' launch counts equal engine passes x 81
   (rmsnorm) and x 40 (fused_ff);
5. training main path — stablelm-3b at full width, bf16, remat, seq 2048,
   global batch 4, 3 steps of ``Trainer``; every loss and grad-norm is
   finite, step 0's loss agrees with the same loss evaluated with every
   kernel replaced by its plain version, and the launch counts equal
   steps x (4L + 1) (rmsnorm), x 2L (fused_ff) and x 2L
   (flash_attention): forward and per-layer recompute;
6. optimizer main path — ``python -m repro_torch.launch.optimize
   matmul_leakyrelu bmm --strategy greedy`` into a fresh schedule cache
   must print the reference's cycles (8294 -> 8289, 8275 -> 8271), then
   ``--deploy`` must read the artifacts back; each deployed kernel is
   launched through the registry, ``get_kernel(name).kernel_fn(a, b,
   **artifact.config)``, on the card at the path's shapes in bf16 and f32
   and held against ``ref_fn``, and each launches once per call;
7. the ``{"kernels": [...]}`` line, then the last line:
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  No phase catches its
own failure, and nothing falls back to the CPU or to a plain version.
Needs the repository's ``src/`` beside this file; imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 and compute by type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Serving path shapes at qwen1.5-4b full width with 8 lanes.
LANES, D_MODEL, D_FF = 8, 2560, 6912
# Training path shapes at stablelm-3b full width: global batch 4 x seq 2048.
BATCH, SEQ, HEADS, HEAD_DIM = 4, 2048, 32, 80
ROWS = BATCH * SEQ
# Optimizer path shapes: K3 as a 3B-class MLP up-projection (8192 rows of
# width 2560 into 6912), K4 as qwen1.5-4b's 20 heads of 128 over 2048
# positions.
MLR_SHAPE = (ROWS, D_MODEL, D_FF)               # M, K, N
BMM_SHAPE = (20, 2048, 128, 2048)               # B, M, K, N
# what launch.optimize prints for the pair: the reference's cycles
OPTIMIZE_LINES = {"matmul_leakyrelu": "8294 -> 8289 cycles",
                  "bmm": "8275 -> 8271 cycles"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def event_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

KERNELS = {   # name -> (source, the TPU kernel it replaces, headline path)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:26", "train"),
    "fused_ff": ("src/repro_torch/kernels/csrc/fused_ff.cu",
                 "src/repro/kernels/fused_ff.py:40", "train"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66", "train"),
    "matmul_leakyrelu": ("src/repro_torch/kernels/csrc/gemm.cu",
                         "src/repro/kernels/matmul_leakyrelu.py:43",
                         "optimize"),
    "bmm": ("src/repro_torch/kernels/csrc/gemm.cu",
            "src/repro/kernels/bmm.py:35", "optimize"),
}


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    print(f"  {name}: max|d| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def record(name, path, shape, err, ms, plain_ms, nbytes, ops, dtype,
           library_ms, **extra):
    t_bound, by = bound(nbytes, ops, dtype)
    src, replaces, _ = KERNELS[name]
    rec = dict(name=name, route="cuda", source=src, replaces=replaces,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
               bound_by=by, library_ms=library_ms, shape=shape, path=path,
               **extra)
    lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
    comp = ("" if "library_composite_ms" not in extra else
            f"  cuBLAS composite {extra['library_composite_ms']:.4f} ms")
    print(f"  time {name} {shape} ({path}): kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {t_bound:.4g} ms ({by}){lib}{comp}",
          flush=True)
    return rec


def rmsnorm_checks(gen, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod

    # bf16 outputs may differ by one bf16 rounding (2^-7 relative) where
    # f32 sums in another order land on either side of a rounding
    # boundary; f32 by rsqrtf's 2 ulp.
    tol = {"bfloat16": (1e-5, 2 ** -7), "float32": (1e-5, 1e-5)}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for rows, cols, path in ((LANES, D_MODEL, "serve"), (13, 1001, None),
                                 (ROWS, D_MODEL, "train")):
            if path == "train" and dname != "bfloat16":
                continue
            x = (torch.randn(rows, cols, device="cuda", generator=gen)
                 * 0.5).to(dt)
            g = (torch.randn(cols, device="cuda", generator=gen) * 0.5
                 + 1.0).to(dt)
            shape = f"{rows}x{cols} {dname}"
            err = check_close(f"rmsnorm {shape}", rms_mod.rmsnorm(x, g),
                              ops.rmsnorm(x, g, impl="ref"), *tol[dname])
            if path is None or dname != "bfloat16":
                continue
            el = x.element_size()
            records.append(record(
                "rmsnorm", path, shape, err,
                event_ms(lambda: rms_mod.rmsnorm(x, g)),
                event_ms(lambda: ops.rmsnorm(x, g, impl="ref")),
                (2 * rows * cols + cols) * el, 4 * rows * cols, dname,
                event_ms(lambda: F.rms_norm(x, (cols,), g, eps=1e-6))))


def fused_ff_checks(gen, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.kernels import ops

    # bf16: one bf16 rounding of the output (2^-7 relative); f32: dot
    # products of up to 2560 terms summed in another order.
    tol = {"bfloat16": (1e-4, 2 ** -7), "float32": (1e-5, 1e-4)}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for m, k, n, path in ((LANES, D_MODEL, D_FF, "serve"),
                              (3, 1001, 777, None),
                              (ROWS, D_MODEL, D_FF, "train")):
            if path == "train" and dname != "bfloat16":
                continue
            x = (torch.randn(m, k, device="cuda", generator=gen)
                 * 0.5).to(dt)
            # At decode, four weight pairs in rotation (283 MB in bf16):
            # each call finds its weights out of the 50 MB L2, as a decode
            # pass does.
            ws = [tuple((torch.randn(k, n, device="cuda", generator=gen)
                         * k ** -0.5).to(dt) for _ in range(2))
                  for _ in range(4 if path == "serve" else 1)]
            shape = f"{m}x{k}x{n} {dname}"
            err = check_close(f"fused_ff {shape}",
                              ff_mod.fused_ff(x, *ws[0]),
                              ops.fused_ff(x, *ws[0], impl="ref"),
                              *tol[dname])
            if path is None or dname != "bfloat16":
                continue
            turn = [0]

            def rotate(fn):
                def call():
                    turn[0] = (turn[0] + 1) % len(ws)
                    return fn(*ws[turn[0]])
                return call

            iters = 30 if path == "serve" else 10
            el = x.element_size()
            records.append(record(
                "fused_ff", path, shape, err,
                event_ms(rotate(lambda a, b: ff_mod.fused_ff(x, a, b)),
                         iters),
                event_ms(rotate(lambda a, b: ops.fused_ff(x, a, b,
                                                          impl="ref")),
                         iters),
                (m * k + 2 * k * n + m * n) * el, 4 * m * k * n + 4 * m * n,
                dname,
                # no single PyTorch call computes silu(x@Wg)*(x@Wu)
                None,
                library_composite_ms=event_ms(rotate(
                    lambda a, b: F.silu(x @ a) * (x @ b)), iters)))
            del ws


def flash_attention_checks(gen, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import NO_WINDOW

    # tests/test_kernels.py's tolerances for this kernel: atol 2e-4 in f32
    # (:91), 3e-2 in bf16 (:104, one bf16 rounding of outputs near 1).
    tol = {"float32": (2e-4, 0.0), "bfloat16": (3e-2, 0.0)}
    cases = [  # B, H, KH, Sq, Sk, D, causal, window, q_offset
        (BATCH, HEADS, HEADS, SEQ, SEQ, HEAD_DIM, True, NO_WINDOW, 0),
        (2, 8, 2, 1000, 1000, HEAD_DIM, True, 256, 0),
        (2, 8, 8, 1000, 1000, HEAD_DIM, False, NO_WINDOW, 0),
        (1, 4, 2, 100, 300, 64, True, NO_WINDOW, 200),
    ]
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for B, H, KH, Sq, Sk, D, causal, window, q_offset in cases:
            q = torch.randn(B, H, Sq, D, device="cuda", generator=gen).to(dt)
            k, v = (torch.randn(B, KH, Sk, D, device="cuda",
                                generator=gen).to(dt) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            win = "" if window == NO_WINDOW else f" window {window}"
            shape = (f"({B},{H},{Sq},{D}) kv ({KH},{Sk}) "
                     f"{'causal' if causal else 'full'}{win}"
                     f"{f' q_offset {q_offset}' if q_offset else ''} "
                     f"{dname}")
            err = check_close(f"flash_attention {shape}",
                              fa_mod.flash_attention(q, k, v, **kw),
                              ops.flash_attention(q, k, v, impl="ref", **kw),
                              *tol[dname])
            if (Sq, dname) != (SEQ, "bfloat16"):
                continue
            el = q.element_size()
            # the (query, key) pairs this run's mask keeps, two products each
            pairs = sum(min(q_offset + i + 1, Sk) for i in range(Sq))
            records.append(record(
                "flash_attention", "train", shape, err,
                event_ms(lambda: fa_mod.flash_attention(q, k, v, **kw), 20),
                event_ms(lambda: ops.flash_attention(q, k, v, impl="ref",
                                                     **kw), 10),
                (2 * B * H * Sq + 2 * B * KH * Sk) * D * el,
                4 * B * H * D * pairs, dname,
                event_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 20)))


def _f64_tolerance(plain, exact, floor):
    """atol at a path's shape: twice the plain version's own error against
    an f64 evaluation of the same function (kernel and plain version round
    the same f32 sums, added in other orders), and at least the test's."""
    return max(floor, 2 * (plain.double() - exact).abs().max().item())


# tests/test_kernels.py's tolerances for K3 and K4: atol (_ATOL :18), rtol
GEMM_TOL = {"float32": (2e-5, 2e-2), "bfloat16": (2e-2, 2e-2)}


def _gemm_inputs(gen, dt, a_shape, b_shape, b_scale=None):
    """a ~ N(0, 0.5^2); b ~ N(0, b_scale^2), by default K^-1/2 (a
    projection's weights: a @ b is O(1))."""
    import torch
    if b_scale is None:
        b_scale = a_shape[-1] ** -0.5
    a = (torch.randn(*a_shape, device="cuda", generator=gen) * 0.5).to(dt)
    b = (torch.randn(*b_shape, device="cuda", generator=gen)
         * b_scale).to(dt)
    return a, b


def gemm_checks(gen, records):
    """K3 and K4, called as the registry calls them (the wrappers, with the
    reference's block-size keywords): ``tests/test_kernels.py``'s cases, a
    ragged shape, and the optimizer path's shapes with times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bmm as bmm_mod
    from repro_torch.kernels import matmul_leakyrelu as mlr_mod
    from repro_torch.kernels import ops

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = GEMM_TOL[dname]
        for m, k, n, bm, bn, bk in ((128, 128, 128, 128, 128, 128),
                                    (256, 256, 128, 128, 128, 128),
                                    (128, 128, 256, 64, 128, 64),
                                    (131, 77, 45, 1, 1, 1)):
            # the test's inputs: both operands N(0, 0.5^2)
            a, b = _gemm_inputs(gen, dt, (m, k), (k, n), 0.5)
            check_close(f"matmul_leakyrelu {m}x{k}x{n} {dname}",
                        mlr_mod.matmul_leakyrelu(a, b, bm=bm, bn=bn, bk=bk),
                        ops.matmul_leakyrelu(a, b, impl="ref"), atol, rtol)
        for B, m, k, n, blk in ((3, 128, 128, 128, 64), (2, 33, 17, 65, 1)):
            a, b = _gemm_inputs(gen, dt, (B, m, k), (B, k, n), 0.5)
            check_close(f"bmm ({B},{m},{k})x({B},{k},{n}) {dname}",
                        bmm_mod.bmm(a, b, bm=blk, bn=blk, bk=blk),
                        ops.bmm(a, b, impl="ref"), atol, rtol)

        m, k, n = MLR_SHAPE
        a, b = _gemm_inputs(gen, dt, (m, k), (k, n))
        plain = ops.matmul_leakyrelu(a, b, impl="ref")
        tol = _f64_tolerance(plain, ops.matmul_leakyrelu(
            a.double(), b.double(), impl="ref"), atol)
        shape = f"{m}x{k}x{n} {dname}"
        err = check_close(f"matmul_leakyrelu {shape}",
                          mlr_mod.matmul_leakyrelu(a, b), plain, tol, 0.0)
        el = a.element_size()
        records.append(record(
            "matmul_leakyrelu", "optimize", shape, err,
            event_ms(lambda: mlr_mod.matmul_leakyrelu(a, b), 10),
            event_ms(lambda: ops.matmul_leakyrelu(a, b, impl="ref"), 10),
            (m * k + k * n + m * n) * el, 2 * m * k * n, dname,
            # no single PyTorch call computes LeakyReLU(a @ b)
            None, library_composite_ms=event_ms(
                lambda: F.leaky_relu(torch.matmul(a, b), 0.01), 10)))
        del a, b, plain

        B, m, k, n = BMM_SHAPE
        a, b = _gemm_inputs(gen, dt, (B, m, k), (B, k, n))
        plain = ops.bmm(a, b, impl="ref")
        tol = _f64_tolerance(plain, ops.bmm(a.double(), b.double(),
                                            impl="ref"), atol)
        shape = f"({B},{m},{k})x({B},{k},{n}) {dname}"
        err = check_close(f"bmm {shape}", bmm_mod.bmm(a, b), plain, tol, 0.0)
        el = a.element_size()
        records.append(record(
            "bmm", "optimize", shape, err,
            event_ms(lambda: bmm_mod.bmm(a, b), 20),
            event_ms(lambda: ops.bmm(a, b, impl="ref"), 20),
            B * (m * k + k * n + m * n) * el, 2 * B * m * k * n, dname,
            event_ms(lambda: torch.bmm(a, b), 20)))
        del a, b, plain


def gradient_checks(gen):
    """Each kernel's ``autograd.Function`` against autograd through its
    plain version, at the training path's shapes in bf16.  Both backward
    passes compute the plain version's gradient in f32 and round it to
    bf16 once, so they may differ by one bf16 rounding (2^-7 relative)
    where f32 sums in another order (K6's backward runs a batch row at a
    time) land on either side of a rounding boundary."""
    import torch
    from repro_torch.kernels import ops

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale
                + shift).to(torch.bfloat16)

    cases = {
        "rmsnorm": (lambda impl, x, g: ops.rmsnorm(x, g, impl=impl),
                    [rnd(ROWS, D_MODEL), rnd(D_MODEL, scale=0.1, shift=1.0)]),
        "fused_ff": (lambda impl, x, a, b: ops.fused_ff(x, a, b, impl=impl),
                     [rnd(ROWS, D_MODEL, scale=0.5),
                      rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
                      rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5)]),
        "flash_attention": (
            lambda impl, q, k, v: ops.flash_attention(q, k, v, impl=impl),
            [rnd(BATCH, HEADS, SEQ, HEAD_DIM) for _ in range(3)]),
    }
    for name, (fn, inputs) in cases.items():
        mine = [t.clone().requires_grad_() for t in inputs]
        plain = [t.clone().requires_grad_() for t in inputs]
        out = fn(None, *mine)
        dy = torch.randn(out.shape, device="cuda",
                         generator=gen).to(out.dtype)
        got = torch.autograd.grad(out, mine, dy)
        want = torch.autograd.grad(fn("ref", *plain), plain, dy)
        for i, (a, b) in enumerate(zip(got, want)):
            scale = b.float().abs().max().item()
            check_close(f"grad {name} input {i} {tuple(b.shape)} bfloat16",
                        a, b, 2 ** -8 * scale, 2 ** -7)
        del mine, plain, got, want


def kernel_phase():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    rmsnorm_checks(gen, records)
    fused_ff_checks(gen, records)
    flash_attention_checks(gen, records)
    gemm_checks(gen, records)
    gradient_checks(gen)
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 3: the same decode on the card and on the host
# ---------------------------------------------------------------------------

def device_host_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import init_paged_caches, paged_decode_step

    cfg = get_config("qwen1.5-4b").replace(n_layers=2, dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    dparams = _tree_to(params, "cuda")
    B, bs, steps = LANES, 16, 4
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.permutation(B * 2).reshape(B, 2).astype(np.int64))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (steps, B, 1)))
    host = init_paged_caches(cfg, B * 2, bs, B)
    dev = init_paged_caches(cfg, B * 2, bs, B, "cuda")
    wmask = torch.ones(B, dtype=torch.bool)
    worst = 0.0
    for t in range(steps):
        pos = torch.full((B,), t)
        h_logits, host = paged_decode_step(params, host, table, toks[t], pos,
                                           wmask, cfg, 2 * bs)
        d_logits, dev = paged_decode_step(dparams, dev, table, toks[t], pos,
                                          wmask, cfg, 2 * bs)
        err = (d_logits.cpu() - h_logits).abs().max().item()
        scale = h_logits.abs().max().item()
        worst = max(worst, err / scale)
        print(f"  pass {t}: max|d| {err:.3e} of max|logit| {scale:.1f}",
              flush=True)
    # f32 dot products over 2560-6912 terms, summed in other orders on the
    # two devices (no TF32): a relative bound on the logit scale.
    print(f"  worst max|d| / max|logit| {worst:.3e} (bound 1e-5)", flush=True)
    if not worst <= 1e-5:
        fail("device and host decode logits disagree")


def device_host_train_step():
    """One train step of full-width stablelm-3b cut to 2 layers, f32, on
    the card and on the host from the same parameters and batch.

    The loss agrees within 1e-4 relative.  The grad-norm cannot: with the
    reference's initialisation (a tied N(0, 1) embedding at width 2560,
    logits in the hundreds) this function's f32 gradients are
    ill-conditioned, and every f32 evaluation of it, on either device,
    lies about 0.5% from an f64 evaluation.  So, as the CPU parity tests
    bound f32 logits and gradients, the grad-norm is held to 1e-4 relative
    plus twice the host's own f32 error against the host's f64
    evaluation."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, compute_grads, make_train_step
    from repro_torch.utils.tree import global_norm

    cfg = get_config("stablelm-3b").replace(n_layers=2, dtype="float32")
    batch = make_data(cfg, 128, 2, seed=0).batch_at(0)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    metrics = {}
    for device in ("cpu", "cuda"):
        opt = adamw(3e-4, weight_decay=0.1, max_grad_norm=1.0)
        p = _tree_to(params, device)
        state = TrainState(p, opt.init(p),
                           torch.zeros((), dtype=torch.int32, device=device))
        _, m = make_train_step(cfg, opt)(state, {
            k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        metrics[device] = {k: float(v) for k, v in m.items()}
    cfg64 = cfg.replace(dtype="float64")
    _, g64 = compute_grads(_tree_to(params, "cpu", torch.float64),
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           cfg64)
    exact = float(global_norm(g64))
    host, dev = metrics["cpu"], metrics["cuda"]
    host_err = abs(host["grad_norm"] - exact) / exact
    rel = {k: abs(dev[k] - host[k]) / abs(host[k])
           for k in ("loss", "grad_norm")}
    bounds = {"loss": 1e-4, "grad_norm": 1e-4 + 2 * host_err}
    print(f"  train step host {host}\n  train step card {dev}\n"
          f"  host f64 grad_norm {exact:.6f}: host f32 off by {host_err:.3e}, "
          f"card f32 by {abs(dev['grad_norm'] - exact) / exact:.3e}\n"
          f"  card against host: relative |d| {rel}, bounds {bounds}",
          flush=True)
    if not all(rel[k] <= bounds[k] for k in rel):
        fail("device and host train steps disagree")


def _tree_to(tree, device, dtype=None):
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 4: the serving main path — full-width qwen1.5-4b through ServeEngine
# ---------------------------------------------------------------------------

def _kernel_modules():
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in KERNELS}


def _reset_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0


def _read_launches():
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _expected_launches(**counts):
    return {name: counts.get(name, 0) for name in KERNELS}


def serve_phase(profile_dir):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine, Tenant, TrafficConfig, run_load
    from repro_torch.utils.tree import param_count

    cfg = get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    engine = ServeEngine.from_config(
        cfg, max_batch=LANES, max_seq=256, block_size=16, paged=True,
        tenants=[Tenant("t0"), Tenant("t1")], rng_seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = param_count(engine.params)
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters in bf16, made "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    engine.generate([1, 2, 3], 2, tenant="t0")      # warm-up: cuBLAS etc.
    engine.finished.clear()
    traffic = TrafficConfig(qps=4.0, n_requests=16, n_tenants=2,
                            prompt_len=(64, 128), output_len=(32, 64),
                            vocab=cfg.vocab, seed=0)

    passes0 = engine.counters["passes"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    report = run_load(engine, traffic)
    torch.cuda.synchronize()
    launches = _read_launches()
    passes = engine.counters["passes"] - passes0

    reqs = engine.finished
    bad = [r.id for r in reqs if r.truncated or len(r.output)
           != r.max_new_tokens or not all(0 <= t < cfg.vocab
                                          for t in r.output)]
    print(f"  requests completed {report['completed']}/"
          f"{report['n_requests']}, tokens {report['tokens']}", flush=True)
    if report["completed"] != traffic.n_requests or len(reqs) \
            != traffic.n_requests or bad:
        fail(f"requests incomplete or out of vocab: {bad}")
    want = _expected_launches(rmsnorm=passes * (2 * cfg.n_layers + 1),
                              fused_ff=passes * cfg.n_layers)
    print(f"  passes {passes}; launches {launches}; expected {want}",
          flush=True)
    if launches != want or passes == 0:
        fail("the main path did not go through the kernels once per site")
    stats = {
        "tokens_per_s": report["tokens_per_s"],
        "latency_p50_s": report["latency_p50_s"],
        "latency_p99_s": report["latency_p99_s"],
        "ttft_p50_s": report["ttft_p50_s"],
        "ttft_p99_s": report["ttft_p99_s"],
        "wall_s": report["wall_s"], "passes": passes,
        "ms_per_pass": report["wall_s"] * 1e3 / passes,
        "lane_utilization": report["stats"]["engine"]["lane_utilization"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("  serving main path " + json.dumps(stats), flush=True)
    if profile_dir:
        profile_passes(engine, cfg, profile_dir)
    del engine
    torch.cuda.empty_cache()
    return launches


def _kernel_breakdown(prof):
    """(lines of device time by kernel name, device-busy microseconds) —
    from the kernels' own events (an op's row in key_averages() repeats
    the time of the kernels it launched)."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + stop - start)
    lines = [f"{t / 1e3:10.3f} ms {n:6d} x {t / n:9.2f} us  {name[:90]}"
             for name, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])]
    return lines, busy_us


def _write_profile(out_dir, name, lines, prof):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(row_limit=60))


def profile_passes(engine, cfg, out_dir: str, n_passes: int = 8):
    """torch.profiler over steady decode passes: device busy share and
    time by kernel, written to ``out_dir``/profile_main_path.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng_prompt = list(range(1, 97))
    for i in range(LANES):
        engine.submit([(t + i) % cfg.vocab for t in rng_prompt], 64,
                      tenant="t0")
    while any(s.in_prefill for s in engine._active) or not engine._active:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        before = engine.counters["passes"]
        while engine.counters["passes"] - before < n_passes:
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = engine.counters["passes"] - before
    lines, busy_us = _kernel_breakdown(prof)
    _write_profile(out_dir, "profile_main_path.txt", lines, prof)
    print(f"  profile: {done} passes in {wall * 1e3:.1f} ms wall (profiler "
          f"on), device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.1%}"
          f" of wall; kernel time by name:", flush=True)
    print("\n".join("    " + line for line in lines[:20]), flush=True)
    engine.run()


# ---------------------------------------------------------------------------
# phase 5: the training main path — full-width stablelm-3b through Trainer
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3


def train_phase(profile_dir):
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import TrainConfig, Trainer, loss_fn
    from repro_torch.utils.tree import param_count

    cfg = get_config("stablelm-3b")
    tcfg = TrainConfig(steps=TRAIN_STEPS, seq_len=SEQ, global_batch=BATCH)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    n_params = param_count(trainer.state.params)
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters in {cfg.dtype}, "
          f"remat {cfg.remat}, made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # step 0's loss evaluated once more with every kernel replaced by its
    # plain version, from the same parameters and batch
    batch0 = {k: torch.from_numpy(v).to("cuda")
              for k, v in trainer.data.batch_at(0).items()}
    with torch.no_grad(), ops.forced("ref"):
        plain_loss = float(loss_fn(trainer.state.params, batch0, cfg)[0])
    del batch0
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    log = trainer.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = BATCH * SEQ
    for row in log:
        print(f"  step {row['step']}: loss {row['loss']:.4f} grad_norm "
              f"{row['grad_norm']:.4f} {row['seconds']:.3f} s "
              f"({tokens / row['seconds']:.0f} tokens/s)", flush=True)
    if len(log) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in log):
        fail("a training loss or grad-norm is not finite")
    # bf16 activations through 32 layers: the kernels and the plain
    # versions round the same values to bf16 at the same places, but
    # their f32 sums run in other orders, so bf16 roundings may flip.
    rel = abs(log[0]["loss"] - plain_loss) / abs(plain_loss)
    print(f"  step 0 loss {log[0]['loss']:.4f}; with the plain versions "
          f"{plain_loss:.4f}; relative |d| {rel:.3e} (bound 1e-2)",
          flush=True)
    if not rel <= 1e-2:
        fail("step 0's loss disagrees with the plain versions' loss")
    L = cfg.n_layers
    want = _expected_launches(rmsnorm=TRAIN_STEPS * (4 * L + 1),
                              fused_ff=TRAIN_STEPS * 2 * L,
                              flash_attention=TRAIN_STEPS * 2 * L)
    print(f"  launches {launches}; expected {want} (forward and per-layer "
          f"recompute)", flush=True)
    if launches != want:
        fail("the training path did not go through the kernels once per "
             "site and pass")
    steady = [r["seconds"] for r in log[1:]]
    stats = {
        "steps": len(log), "wall_s": wall,
        "step_s": [r["seconds"] for r in log],
        "steady_step_s": statistics.median(steady),
        "tokens_per_s": tokens / statistics.median(steady),
        "loss": [r["loss"] for r in log],
        "grad_norm": [r["grad_norm"] for r in log],
        "max_memory_allocated_gb": peak_gb,
    }
    print("  training main path " + json.dumps(stats), flush=True)
    if profile_dir:
        profile_train_step(trainer, profile_dir)
    return launches


def profile_train_step(trainer, out_dir: str):
    """torch.profiler over one more train step: device busy share and time
    by kernel, written to ``out_dir``/profile_train_step.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = trainer.tcfg.steps
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in trainer.data.batch_at(step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    lines, busy_us = _kernel_breakdown(prof)
    _write_profile(out_dir, "profile_train_step.txt", lines, prof)
    print(f"  profile: one train step in {wall * 1e3:.1f} ms wall (profiler "
          f"on), device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.1%}"
          f" of wall; kernel time by name:", flush=True)
    print("\n".join("    " + line for line in lines[:25]), flush=True)


# ---------------------------------------------------------------------------
# phase 6: the optimizer main path — launch.optimize, deploy, the registry
# ---------------------------------------------------------------------------

def _optimize_cli(cache_dir, *extra):
    """``python -m repro_torch.launch.optimize matmul_leakyrelu bmm
    --strategy greedy``, as a user runs it; returns its output lines."""
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.optimize",
           *OPTIMIZE_LINES, "--strategy", "greedy", "--cache-dir", cache_dir,
           *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    print(f"  $ python {' '.join(cmd[1:])}  ({time.perf_counter() - t0:.1f} s)"
          f"\n" + "\n".join("    " + line for line in proc.stdout.splitlines()),
          flush=True)
    if proc.returncode != 0:
        fail(f"launch.optimize exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.stdout.splitlines()


def optimize_phase():
    """The optimizer pipeline on the host (its measurement is the simulated
    TSASS machine, as in the reference), then the deployed kernels on the
    card through the registry."""
    import shutil
    import tempfile

    import torch
    from repro_torch.kernels import get_kernel
    from repro_torch.sched import OptimizationSession

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_",
                                 dir=os.path.join(ROOT, "build"))
    try:
        searched = _optimize_cli(cache_dir)
        deployed = _optimize_cli(cache_dir, "--deploy")
        for name, cycles in OPTIMIZE_LINES.items():
            if not any(line.startswith(f"[optimize] {name}: {cycles} ")
                       for line in searched):
                fail(f"launch.optimize did not print {name}: {cycles}")
            if not any(line.startswith(f"[optimize] {name}: cached config ")
                       and f" {cycles} " in line for line in deployed):
                fail(f"launch.optimize --deploy did not read back {name}: "
                     f"{cycles}")
        session = OptimizationSession(strategy="greedy", cache_dir=cache_dir)
        configs = {name: session.deploy(name).config
                   for name in OPTIMIZE_LINES}
    finally:
        shutil.rmtree(cache_dir)

    gen = torch.Generator(device="cuda").manual_seed(1)
    m, k, n = MLR_SHAPE
    B, bm, bk, bn = BMM_SHAPE
    shapes = {"matmul_leakyrelu": ((m, k), (k, n)),
              "bmm": ((B, bm, bk), (B, bk, bn))}
    inputs = {(name, dname): _gemm_inputs(gen, dt, *shapes[name])
              for dname, dt in (("bfloat16", torch.bfloat16),
                                ("float32", torch.float32))
              for name in OPTIMIZE_LINES}
    torch.cuda.synchronize()
    _reset_launches()
    outs = {key: get_kernel(key[0]).kernel_fn(a, b, **configs[key[0]])
            for key, (a, b) in inputs.items()}
    torch.cuda.synchronize()
    launches = _read_launches()
    want = _expected_launches(matmul_leakyrelu=2, bmm=2)
    print(f"  deployed configs {configs}; launches {launches}; expected "
          f"{want}", flush=True)
    if launches != want:
        fail("the optimizer path did not launch each deployed kernel once "
             "per call")
    for (name, dname), got in outs.items():
        a, b = inputs[name, dname]
        ref_fn = get_kernel(name).ref_fn
        plain = ref_fn(a, b)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"deployed {name} {dname}: misshapen or non-finite output")
        tol = _f64_tolerance(plain, ref_fn(a.double(), b.double()),
                             GEMM_TOL[dname][0])
        check_close(f"deployed {name} {configs[name]} {dname}", got, plain,
                    tol, 0.0)
    del inputs, outs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile decode passes and a train step "
                         "with torch.profiler and write the tables to DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernel library: built in {_build.build_seconds} s "
          f"(None: found built), loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phase("2 kernels")
    records = kernel_phase()

    phase("3 device against host")
    device_host_phase()
    device_host_train_step()

    phase("4 serving main path")
    launches = {"serve": serve_phase(args.profile)}

    phase("5 training main path")
    launches["train"] = train_phase(args.profile)

    phase("6 optimizer main path")
    launches["optimize"] = optimize_phase()

    phase("7 kernels")
    kernels = []
    for name, (_, _, headline) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        # the headline numbers are those at the kernel's own path's shape,
        # in bf16
        entry = {k: v for k, v in next(
            r for r in mine if r["path"] == headline
            and r["shape"].endswith("bfloat16")).items()
                 if k not in ("shape", "path")}
        by_path = {p: launches[p][name] for p in launches}
        if not sum(by_path.values()):
            fail(f"{name} was launched no time on the main paths")
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path,
                     shapes=[{k: v for k, v in r.items()
                              if k not in ("name", "route", "source",
                                           "replaces")} for r in mine])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
