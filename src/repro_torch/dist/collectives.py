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

Every collective reports itself, once where it is issued, to each
observer in :data:`OBSERVERS` (``launch.roofline.count_collectives``
opens one): its kind (the reference's HLO names: ``psum``/``pmean`` an
``all-reduce`` an axis, ``all_gather`` an ``all-gather``,
``psum_scatter`` a ``reduce-scatter``, ``all_to_all`` an
``all-to-all``, ``ppermute``/``shift_down`` a ``collective-permute``),
its result on this rank and the global ranks of its group.  With no
observer open a report costs one test of an empty list.

Transport: when the mesh runs the ``gloo`` backend on CUDA tensors (ranks
that share one card, which NCCL refuses), every collective stages its
tensor through the host explicitly (gloo takes no CUDA tensor for a
point-to-point send); ``nccl`` and CPU tensors go as they are.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

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


# open observers of the collectives: each is called as
# ``observer(kind, result, ranks)``
OBSERVERS: List[Callable[[str, torch.Tensor, Tuple[int, ...]], None]] = []


def _report(kind: str, result: torch.Tensor, ranks) -> None:
    for observer in OBSERVERS:
        observer(kind, result, tuple(ranks))


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
    return _wire_on(x, axis.mesh)


def _wire_on(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh.staged and x.device.type != "cpu":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


# Host-staged sums of at most this many bytes go as an all-gather and a
# sum on the host, larger ones as gloo's all-reduce: among 4 ranks
# sharing an H100 (one torch thread each) the all-gather and sum took
# 3.5-4.4 ms at 40 and 80 KB against the all-reduce's 6.4-7.0, 8.7 and
# 8.9 ms at 1.2 MB against 12.1 and 9.0 (two runs), and 9.4,
# 11.4, 20.6 and 120.1 ms at 1.5, 2, 4 and 21 MB against 8.3, 8.9, 11.0
# and 40.7 (tools/collective_latency.py).
GATHER_SUM_BYTES = 1 << 20


def _all_reduce(x: torch.Tensor, axes: Tuple[Axis, ...],
                kind: str = "all-reduce") -> torch.Tensor:
    """Sum of ``x`` over ``axes`` (one collective an axis of size > 1, in
    the order given): an all-reduce, or where the mesh stages through the
    host and ``x`` is small, an all-gather summed in the group's rank
    order, the same on every rank.  Each is reported as ``kind`` (none
    where ``kind`` is empty: the caller reports)."""
    live = [a for a in axes if a.size > 1]
    if not live:
        return x.clone()
    buf = _wire(x, live[0])
    for a in live:
        if kind:
            _report(kind, x, a.ranks)
        if a.mesh.staged and \
                buf.numel() * buf.element_size() <= GATHER_SUM_BYTES:
            buf = _gather_flat(buf, a).sum(dim=0)
        else:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=a.group)
    return buf.to(x.device)


def _permute(x: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: along ``axis``, index ``src`` sends ``x`` to
    index ``dst`` for each pair; an index that receives nothing returns
    zeros."""
    return _permute_ranks(x, axis.mesh, axis.ranks, axis.index, perm,
                          axis.group)


def _permute_ranks(x: torch.Tensor, mesh, ranks, me: int, perm,
                   group=None) -> torch.Tensor:
    """:func:`_permute` over the indices of ``ranks`` (global ranks; of
    ``group``'s when one is given), this rank at index ``me``."""
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if len(recvs) > 1:
        raise ValueError(f"ppermute: index {me} receives twice in {perm}")
    if sends == [me] and recvs == [me]:
        return x.clone()
    _report("collective-permute", x, ranks)
    buf = _wire_on(x, mesh)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, ranks[d], group) for d in sends]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in recvs]
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


def shift_down(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """``jax.lax.ppermute`` by one step down the combined index of
    ``axis`` (several axes combine major to minor, in mesh order): index
    ``i`` receives index ``i + 1``'s ``x`` and the last index zeros.  Not
    differentiable.  A sequence-sharded ring buffer moves its blocks'
    first rows with it."""
    live = [a for a in _axes(axis) if a.size > 1]
    if not live:
        return torch.zeros_like(x)
    mesh = live[0].mesh
    ranks = mesh.axis_ranks([a.name for a in live])
    me = 0
    for a in live:
        me = me * a.size + a.index
    perm = [(i + 1, i) for i in range(len(ranks) - 1)]
    return _permute_ranks(x, mesh, ranks, me, perm)


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
    parts = _gather_flat(_wire(x, axis), axis).to(x.device)
    # parts come in the group's rank order; put them in coordinate order
    return [parts[dist.get_group_rank(axis.group, r)] for r in axis.ranks]


def _gather_flat(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``buf`` (a wire buffer) along ``axis``, stacked in
    the group's rank order, by one all-gather of flat buffers."""
    out = buf.new_empty(axis.size * buf.numel())
    dist.all_gather_into_tensor(out, buf.reshape(-1), group=axis.group)
    return out.view(axis.size, *buf.shape)


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
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        _report("all-gather", out, axis.ranks)
        return out

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
        out = block_of(_all_reduce(x, (axis,), kind=""), axis,
                       dim).contiguous()
        if axis.size > 1:
            _report("reduce-scatter", out, axis.ranks)
        return out

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
    _report("all-to-all", send, axis.ranks)
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
