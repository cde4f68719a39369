"""Named-axis collectives over ``torch.distributed``, one process per rank.

The port's counterpart of what the reference calls inside
``jax.shard_map``: ``jax.lax.axis_index``, ``psum``, ``pmean`` and
``ppermute`` over a mesh axis.  There a named axis is resolved by the
enclosing ``shard_map``; here it is an :class:`Axis`, bound to a
:class:`repro_torch.launch.mesh.Mesh` (``mesh.axis("pipe")``), which
knows this rank's coordinate on it, its peers' global ranks and the
process group that joins them.

:func:`psum` and :func:`ppermute` are ``torch.autograd.Function``s whose
backward is JAX's transpose under ``shard_map(check_vma=False)``, the
reference's setting, and not Megatron's conjugate operators: ``psum``'s
backward is a ``psum`` of the cotangent (the reference's pipeline step
masks the loss to one (pipe, model) rank, and an identity backward would
hand the other model ranks zero gradients), and ``ppermute``'s backward
is the inverse permutation.  Every rank must issue the same collectives
in the same order in forward and in backward; the callers keep the
reference's SPMD form for that (see :mod:`repro_torch.dist.pipeline`).

Transport: when the mesh runs the ``gloo`` backend on CUDA tensors (ranks
that share one card, which NCCL refuses), every collective stages its
tensor through the host explicitly (gloo takes no CUDA tensor for a
point-to-point send); ``nccl`` and CPU tensors go as they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist


class Axis:
    """One axis of a mesh, seen from this rank: ``name``, ``size``,
    ``index`` (this rank's coordinate), ``ranks`` (the global ranks along
    the axis through this rank, by coordinate) and ``group``."""

    def __init__(self, mesh, name: str):
        self.mesh, self.name = mesh, name
        self.size = mesh.shape[name]
        self.index = mesh.coords[name]
        self.ranks = mesh.axis_ranks(name)
        self.group = mesh.group(name)

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


Axes = Union[Axis, Sequence[Axis]]


def _axes(axis: Axes) -> Tuple[Axis, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on the mesh axis named ``axis``
    (``jax.lax.axis_index``; a bound :class:`Axis` holds it as
    ``index``)."""
    return mesh.coords[axis]


def axis_size(axis: Axes) -> int:
    n = 1
    for a in _axes(axis):
        n *= a.size
    return n


def _wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` as the transport takes it: a contiguous host copy where the
    mesh stages through the host, else a contiguous copy in place."""
    if axis.mesh.staged and x.device.type != "cpu":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(x: torch.Tensor, axes: Tuple[Axis, ...]) -> torch.Tensor:
    """Sum of ``x`` over ``axes`` (one all-reduce an axis of size > 1, in
    the order given)."""
    live = [a for a in axes if a.size > 1]
    if not live:
        return x.clone()
    buf = _wire(x, live[0])
    for a in live:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=a.group)
    return buf.to(x.device)


def _permute(x: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: along ``axis``, index ``src`` sends ``x`` to
    index ``dst`` for each pair; an index that receives nothing returns
    zeros."""
    me = axis.index
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if len(recvs) > 1:
        raise ValueError(f"ppermute: index {me} receives twice in {perm}")
    if sends == [me] and recvs == [me]:
        return x.clone()
    buf = _wire(x, axis)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, axis.ranks[d], axis.group)
           for d in sends]
    ops += [dist.P2POp(dist.irecv, out, axis.ranks[s], axis.group)
            for s in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.axes), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _PPermute.apply(g, ctx.axis, inverse), None, None


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Sum of ``x`` over every rank of ``axis`` (an :class:`Axis` or a
    sequence of them); differentiable, its backward a ``psum`` of the
    cotangent."""
    return _PSum.apply(x, _axes(axis))


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Mean of ``x`` over every rank of ``axis``."""
    return psum(x, axis) / axis_size(axis)


def ppermute(x: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """``x`` sent along ``axis`` by ``perm``, a sequence of ``(src, dst)``
    coordinates; differentiable, its backward the inverse permutation."""
    return _PPermute.apply(x, axis, tuple(tuple(p) for p in perm))


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ``axis.size`` blocks ``x`` of every rank along ``axis``,
    concatenated on a new leading dimension in coordinate order (not
    differentiable: checkpoints and tests gather with it)."""
    if axis.size == 1:
        return x[None].clone()
    buf = _wire(x, axis)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    # parts come in the group's rank order; put them in coordinate order
    return torch.stack([parts[dist.get_group_rank(axis.group, r)]
                        for r in axis.ranks]).to(x.device)
