"""Compressed cross-pod gradient reduction with error feedback.

Port of ``repro/dist/compress.py``.  Over the slow ``pod`` axis the
gradient all-reduce runs quantized: each step the local gradient plus
the carried *error-feedback* residual is rounded to bf16, the bf16
payload is psum-averaged, and the rounding error is carried into the
next step.  The residual makes the scheme unbiased over time — the
accumulated average converges to the true mean (1-bit-Adam / EF-SGD
argument).

Usage on every rank of the reduction axis (``mesh.axis("pod")``)::

    err = ef_state(grads)                     # once, before the steps
    avg, err = compressed_psum(grads, err, pod)

Each leaf is its own all-reduce, so grouping the leaves differently
(:func:`compressed_psum_grouped`) moves no bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist import collectives as col
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

COMPRESSED_DTYPE = torch.bfloat16


def ef_state(tree):
    """Zero-initialized f32 error-feedback accumulators matching ``tree``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def compressed_psum(grads, err, axis) -> Tuple[object, object]:
    """Mean-reduce ``grads`` over ``axis`` (a bound
    :class:`repro_torch.dist.collectives.Axis`) with a bf16 payload and
    error feedback; every rank of ``axis`` calls it.

    Returns ``(avg, new_err)``: the (replicated) quantized mean and the
    residual to carry into the next step.
    """
    n = col.axis_size(axis)
    avg, new_err = [], []
    with torch.no_grad():
        for g, e in zip(tree_leaves(grads), tree_leaves(err)):
            corrected = g.float() + e
            quantized = corrected.to(COMPRESSED_DTYPE)
            new_err.append(corrected - quantized.float())
            # reduce in the compressed dtype — upcasting first would put
            # f32 back on the wire.  The reduction's own bf16 rounding is
            # NOT error-fed-back (only local quantization is), but it is
            # bounded per step and unbiased in expectation.
            avg.append(col.psum(quantized, axis).float() / n)
    return tree_unflatten(grads, avg), tree_unflatten(err, new_err)


def compressed_psum_grouped(grads, err, axis, group_order):
    """:func:`compressed_psum` issued as independent per-group reductions.

    ``grads``/``err`` are dicts of subtrees; ``group_order`` lists their
    keys in *issue order* (the pipeline step lists the stage groups
    first, then glue).  Quantization and reduction are elementwise, so
    the result is bit-identical to one tree-wide :func:`compressed_psum`.

    Returns ``(avg, new_err)`` dicts keyed like ``grads``.
    """
    missing = set(grads) - set(group_order)
    if missing:
        raise ValueError(f"group_order misses gradient groups {missing}")
    avg: dict = {}
    new_err: dict = {}
    for k in group_order:
        if k not in grads:
            continue
        avg[k], new_err[k] = compressed_psum(grads[k], err[k], axis)
    return avg, new_err
