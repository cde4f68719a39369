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

:func:`all_gather`, :func:`psum_scatter` and :func:`all_to_all` are
the GSPMD step's collectives (``make_train_step(mesh=...)``), each
differentiable with JAX's transpose for its backward: an all-gather's
is a ``psum_scatter`` of the cotangent (so a parameter gathered over
``data`` before use gets its gradient summed and scattered back to its
shard, FSDP's reduce-scatter), a ``psum_scatter``'s an all-gather, and
an all-to-all's the all-to-all that swaps its split and concat
dimensions.  A ``psum_scatter`` is an all-reduce followed by this
rank's block (gloo has no reduce-scatter on every build).

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


def _gather_parts(x: torch.Tensor, axis: Axis):
    """Every rank's ``x`` along ``axis``, in coordinate order."""
    buf = _wire(x, axis)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    # parts come in the group's rank order; put them in coordinate order
    return [parts[dist.get_group_rank(axis.group, r)].to(x.device)
            for r in axis.ranks]


def block_of(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` split ``axis.size`` ways along ``dim``
    (a view)."""
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{axis.size} ways over {axis.name!r}")
    size = n // axis.size
    return x.narrow(dim, axis.index * size, size)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, tiled):
        ctx.axis, ctx.dim, ctx.tiled = axis, dim, tiled
        if axis.size == 1:
            return x.unsqueeze(dim).clone() if not tiled else x.clone()
        parts = _gather_parts(x, axis)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            return _PSumScatter.apply(g, ctx.axis, ctx.dim), None, None, None
        block = _PSumScatter.apply(g, ctx.axis, ctx.dim)
        return block.squeeze(ctx.dim), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return block_of(_all_reduce(x, (axis,)), axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.axis, ctx.dim, True), None, None


def _exchange(x: torch.Tensor, axis: Axis, split: int,
              concat: int) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=False)``: block ``j`` of ``x`` along
    ``split`` (whose size is ``axis.size``) goes to coordinate ``j``, and
    the blocks received, by source coordinate, stack on a new dimension
    ``concat`` of the result."""
    if x.shape[split] != axis.size:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} is "
                         f"not the size of {axis!r}")
    if axis.size == 1:
        return x.squeeze(split).unsqueeze(concat).clone()
    # blocks in the group's rank order, as all_to_all_single sends them
    order = [dist.get_group_rank(axis.group, r) for r in axis.ranks]
    blocks = x.unbind(split)
    send = torch.stack([blocks[order.index(g)] for g in range(axis.size)])
    buf = _wire(send, axis)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=axis.group)
    out = out.to(x.device)
    return torch.stack([out[order[j]] for j in range(axis.size)], concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _exchange(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_AllToAll.apply(g, ctx.axis, ctx.concat, ctx.split), None,
                None, None)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather``: the blocks ``x`` of every rank along
    ``axis`` in coordinate order, stacked on a new dimension ``dim``, or
    with ``tiled`` concatenated along ``dim``; differentiable, its
    backward a :func:`psum_scatter` of the cotangent."""
    return _AllGather.apply(x, axis, dim, tiled)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(tiled=True)``: the sum of ``x`` over
    ``axis``, of which this rank keeps its block along ``dim``;
    differentiable, its backward a tiled :func:`all_gather`."""
    return _PSumScatter.apply(x, axis, dim)


def all_to_all(x: torch.Tensor, axis: Axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=False)``: ``x.shape[split_axis]`` is the axis size; block ``j``
    along it goes to coordinate ``j``, and the blocks received stack on
    ``concat_axis`` by source.  Differentiable: the backward is the
    all-to-all with the two dimensions swapped."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)
