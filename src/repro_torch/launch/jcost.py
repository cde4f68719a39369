"""Analytical cost of one rank's step, counted op by op as it runs.

Port of ``repro/launch/jcost.py``.  The reference walks a jaxpr and
multiplies each ``scan`` body by its trip count; the port runs the step
itself (on fake tensors inside the dry run, so nothing is allocated or
computed) under :class:`CostMode`, a ``TorchDispatchMode`` that sees
every aten op after autograd, the backward pass included.  The layers
run as a Python loop, so every layer is seen and no trip count is
needed, and the recompute that ``torch.utils.checkpoint`` does in the
backward pass is seen as it runs, as the reference counts remat.

The reference's rules, mapped onto aten ops:

==================  ==============================  =====================
reference (jaxpr)   port (aten)                     counted
==================  ==============================  =====================
``dot_general``     ``mm``, ``bmm``, ``addmm``,     2·batch·m·n·k flops;
                    ``baddbmm``, ``mv``, ``dot``,   operands + result to
                    ``convolution`` (what           ``bytes_naive`` and
                    ``matmul``/``einsum``/          ``bytes_fused``
                    ``linear`` decompose into)
``_FREE``           views, reshapes, permutes,      no flops; result to
(reshape,           expands, squeezes, dtype        ``bytes_naive``
transpose, ...)     casts, copies, slices, ``cat``,
                    ``stack``, ``split``,
                    ``arange``/``full``/``zeros``
``_HEAVY``          ``embedding``, ``index``,       result to both
(gather, scatter,   ``index_select``, ``gather``,
dynamic slices)     ``scatter``/``scatter_add``/
                    ``index_put``/``index_add``,
                    ``slice_scatter``
everything else     every other aten op             1 flop an output
                                                    element; operands +
                                                    result to
                                                    ``bytes_naive``
arguments           the tensors in ``args``         their bytes to
                                                    ``bytes_fused`` once
==================  ==============================  =====================

``bytes_naive`` models no fusion (every op reads and writes HBM);
``bytes_fused`` perfect elementwise fusion (only the matrix products,
the gathers and scatters and the arguments touch HBM).  Collectives
(the ``c10d`` ops) are counted by ``roofline.count_collectives``, not
here.

``fused_attn=True`` counts each ``kernels.ops.flash_attention`` call as
one op: the flops of its plain version, and for ``bytes_fused`` q, k, v
and the output once each, the kernel's HBM traffic, as the reference
models the Pallas flash kernel on its online-softmax loops.  The
attention's backward pass runs outside the call and is counted op by op.

The figures are one rank's.  ``launch.dryrun`` multiplies them by the
rank count for the global figures, which over-counts work that every
rank repeats (replicated compute), where the reference's jaxpr of the
global program counts it once: the GSPMD step's layers that compute
replicated over ``model`` (ROADMAP §A.4) are the known case.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv", "addbmm",
           "convolution"}
_FREE = {"view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
         "transpose", "t", "expand", "squeeze", "unsqueeze", "_to_copy",
         "to", "copy", "copy_", "clone", "contiguous", "alias", "detach",
         "lift_fresh", "lift_fresh_copy", "slice", "select", "narrow",
         "cat", "stack", "split", "split_with_sizes", "unbind", "chunk",
         "as_strided", "unfold", "flip", "arange", "full", "zeros",
         "zeros_like", "ones", "ones_like", "empty", "empty_like",
         "empty_strided", "new_zeros", "new_empty", "new_ones", "new_full",
         "full_like", "scalar_tensor", "_unsafe_split", "view_as_real",
         "view_as_complex", "expand_as", "repeat", "_to_dtype"}
_HEAVY = {"embedding", "embedding_dense_backward", "index", "index_select",
          "gather", "scatter", "scatter_add", "scatter_reduce", "index_put",
          "index_put_", "_index_put_impl_", "index_add", "index_add_",
          "index_copy", "slice_scatter", "select_scatter", "take",
          "take_along_dim"}


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if isinstance(
        t, torch.Tensor) else 0.0


def tensors(tree):
    """The tensors among the leaves of ``tree``."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes_naive: float = 0.0
    bytes_fused: float = 0.0
    # the matrix products' share of ``flops`` (the reference's
    # ``dot_general`` flops)
    matmul_flops: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes_naive": self.bytes_naive,
                "bytes_fused": self.bytes_fused}


def matmul_flops(name: str, args, out) -> float:
    """2·batch·m·n·k of a matrix product ``name`` (an aten op's name)."""
    if name == "convolution":
        # out (N, C_out, *spatial); weight (C_out, C_in / groups, *kernel)
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addmv",
                                          "addbmm") else (args[0], args[1])
    if name in ("mv", "addmv", "dot"):
        return 2.0 * a.numel()
    # a (..., m, k) @ b (..., k, n): k is a's last dimension
    k = a.shape[-1]
    m_batch = a.numel() // k
    n = b.shape[-1]
    return 2.0 * m_batch * n * k


class CostMode(TorchDispatchMode):
    """Counts :class:`Cost` over every aten op dispatched while it is
    open (see the module docstring for the rules)."""

    def __init__(self, fused_attn: bool = False):
        super().__init__()
        self.cost = Cost()
        self.fused_attn = fused_attn
        self._in_attention = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten":
            self._count(func._overloadpacket.__name__, args, kwargs, out)
        return out

    def _count(self, name: str, args, kwargs, out) -> None:
        c = self.cost
        outs = tensors(out)
        out_bytes = sum(_nbytes(t) for t in outs)
        fused = not self._in_attention
        if name in _FREE:
            c.bytes_naive += out_bytes
            return
        if name in _HEAVY:
            c.bytes_naive += out_bytes
            if fused:
                c.bytes_fused += out_bytes
            return
        io_bytes = out_bytes + sum(_nbytes(t)
                                   for t in tensors((args, kwargs)))
        c.bytes_naive += io_bytes
        if name in _MATMUL:
            f = matmul_flops(name, args, outs[0])
            c.flops += f
            c.matmul_flops += f
            if fused:
                c.bytes_fused += io_bytes
        else:
            c.flops += max(float(sum(t.numel() for t in outs)), 1.0)

    def attention(self, q, k, v):
        """The region of one ``ops.flash_attention`` call (an observer of
        ``kernels.ops.ATTENTION_OBSERVERS``): its ops add no
        ``bytes_fused``; q, k, v and the output add theirs once."""
        return _AttentionRegion(self, q, k, v)


class _AttentionRegion:
    def __init__(self, mode: CostMode, q, k, v):
        self.mode, self.ins = mode, (q, k, v)

    def __enter__(self):
        self.mode._in_attention += 1
        self.mode.cost.bytes_fused += sum(_nbytes(t) for t in self.ins)
        return self.done

    def done(self, out) -> None:
        self.mode.cost.bytes_fused += _nbytes(out)

    def __exit__(self, *exc) -> None:
        self.mode._in_attention -= 1


class counting:
    """``with counting(fused_attn) as mode:`` counts every op run inside
    into ``mode.cost`` (a :class:`CostMode`, with ``fused_attn`` also an
    observer of ``ops.flash_attention``)."""

    def __init__(self, fused_attn: bool = False):
        self.mode = CostMode(fused_attn)

    def __enter__(self) -> CostMode:
        from repro_torch.kernels import ops
        if self.mode.fused_attn:
            ops.ATTENTION_OBSERVERS.append(self.mode.attention)
        self.mode.__enter__()
        return self.mode

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops
        self.mode.__exit__(*exc)
        if self.mode.fused_attn:
            ops.ATTENTION_OBSERVERS.remove(self.mode.attention)


def cost_of(fn, *args, fused_attn: bool = False) -> Dict[str, float]:
    """Analytical cost of ``fn(*args)`` on this rank: ``flops``,
    ``bytes_naive`` and ``bytes_fused``.  ``fn`` runs once; give it fake
    tensors (``FakeTensorMode``) to count without computing.
    ``fused_attn=True`` models the flash kernel (see the module
    docstring)."""
    with counting(fused_attn) as mode:
        fn(*args)
    # parameters/arguments are read at least once per step
    mode.cost.bytes_fused += sum(_nbytes(t) for t in tensors(args))
    return mode.cost.as_dict()
