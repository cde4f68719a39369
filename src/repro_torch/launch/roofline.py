"""Roofline terms of a dry-run cell, against one NVIDIA H100 SXM.

Port of ``repro/launch/roofline.py``.  The H100 constants below are
the one place the port keeps its peaks (``chip_smoke.py`` imports them):

  compute term    = flops_global / (chips x PEAK_FLOPS[dtype])
  memory term     = bytes_fused_global / (chips x HBM_BW)
  collective term = sum over this rank's collectives of bytes / link rate

The reference parses the partitioned program's HLO for its collectives
and charges them all at one link rate.  The port has no HLO: its
collectives (:mod:`repro_torch.dist.collectives`) report themselves to
:func:`count_collectives` as they are issued, forward and backward, with
the reference's byte rule (the bytes of the collective's result on this
rank: the gathered buffer of an all-gather, the scattered block of a
reduce-scatter) and the global ranks of their group.  A collective goes
at NVLink's rate where every rank of its group lies in one node of
``NODE_GPUS`` (``rank // NODE_GPUS`` equal), else at the network's.

``analyze`` takes its flops and bytes from :mod:`repro_torch.launch.jcost`
(``cost``: one rank's, times ``chips`` for the global figures) and
records beside them ``torch_flops_global``, the count of
``torch.utils.flop_counter.FlopCounterMode`` over the same cell (the
library's own counter, as the reference records XLA's
``cost_analysis``).  The reference's ``xla_bytes_global`` has no
counterpart: no torch counter models HBM traffic, and ``bytes_naive``
(every op's operands and result) is recorded instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity): bf16 tensor cores
# 989 TFLOP/s, f32 (non-tensor) 67 TFLOP/s.
PEAK_FLOPS: Dict[str, float] = {"bfloat16": 989e12, "float32": 67e12}
# H100 SXM5 data sheet: HBM3, 3.35 TB/s.
HBM_BW = 3.35e12
# NVLink 4 (H100 SXM5 data sheet): 900 GB/s a GPU in both directions
# together, 450 GB/s each way.
NVLINK_BW = 450e9
# One 400 Gb/s NDR InfiniBand link a GPU, as DGX/HGX H100 systems are
# cabled (NVIDIA DGX H100 user guide: eight ConnectX-7 400 Gb/s ports
# for the eight GPUs): 50 GB/s.
NET_BW = 50e9
# GPUs a node (DGX/HGX H100), joined all to all by NVLink
NODE_GPUS = 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def link_bw(ranks) -> float:
    """The rate of a collective over the global ``ranks``: NVLink's where
    they all lie in one node, else the network's."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 \
        else NET_BW


class CollectiveCount:
    """What :func:`count_collectives` saw: ``ops``, one ``(kind, bytes,
    ranks)`` a collective in issue order."""

    def __init__(self):
        self.ops: List[Tuple[str, float, Tuple[int, ...]]] = []

    def __call__(self, kind: str, result, ranks) -> None:
        self.ops.append((kind, float(result.numel()
                                     * result.element_size()), ranks))

    def as_dict(self) -> Dict:
        """The reference's ``collective_bytes`` record: bytes by kind, then
        ``total``, then ``counts`` (ops by kind)."""
        out: Dict = {c: 0.0 for c in COLLECTIVES}
        counts = {c: 0 for c in COLLECTIVES}
        for kind, nbytes, _ in self.ops:
            out[kind] += nbytes
            counts[kind] += 1
        out["total"] = sum(out[c] for c in COLLECTIVES)
        out["counts"] = counts
        return out

    def seconds(self) -> float:
        """The collective term of one rank: each collective's bytes over
        its group's link rate, summed."""
        return sum(nbytes / link_bw(ranks) for _, nbytes, ranks in self.ops)


@contextlib.contextmanager
def count_collectives() -> Iterator[CollectiveCount]:
    """Count every collective of :mod:`repro_torch.dist.collectives` that
    this process issues while the context is open."""
    from repro_torch.dist import collectives
    count = CollectiveCount()
    collectives.OBSERVERS.append(count)
    try:
        yield count
    finally:
        collectives.OBSERVERS.remove(count)


@dataclasses.dataclass
class Roofline:
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    coll_breakdown: Optional[Dict] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(cost: Dict, chips: int, model_flops: Optional[float] = None,
            coll: Optional[CollectiveCount] = None,
            torch_flops: Optional[float] = None) -> Roofline:
    """The roofline of one cell from ``cost`` (``jcost.cost_of``: one
    rank's ``flops``, ``bytes_naive`` and ``bytes_fused``), ``chips``
    ranks running the same program, and ``coll`` (what
    :func:`count_collectives` saw of one rank).  ``torch_flops`` is
    ``FlopCounterMode``'s count of one rank, recorded beside.  The
    compute peak is bf16's, as every production config computes in bf16
    (the reference has one peak too)."""
    flops_global = float(cost["flops"]) * chips
    bytes_global = float(cost["bytes_fused"]) * chips
    breakdown = coll.as_dict() if coll is not None else \
        CollectiveCount().as_dict()
    breakdown["bytes_naive_global"] = float(cost["bytes_naive"]) * chips
    if torch_flops is not None:
        breakdown["torch_flops_global"] = float(torch_flops) * chips
    coll_global = breakdown["total"] * chips

    compute_s = flops_global / (chips * PEAK_FLOPS["bfloat16"])
    memory_s = bytes_global / (chips * HBM_BW)
    collective_s = coll.seconds() if coll is not None else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = (model_flops / flops_global) \
        if (model_flops and flops_global) else None
    return Roofline(chips=chips, flops_global=flops_global,
                    bytes_global=bytes_global, coll_bytes_global=coll_global,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, dominant=dominant,
                    model_flops=model_flops, useful_ratio=useful,
                    coll_breakdown=breakdown)
