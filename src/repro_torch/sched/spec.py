"""Kernel schedule specs: the contract between kernels and the TSASS
lowering/optimization pipeline (the cubin-interception point of the
paper's Fig. 2).  Port of ``repro/sched/spec.py``.

A :class:`KernelSpec` describes the *steady-state inner loop* of a tiled
kernel: which HBM tiles are DMA'd in per grid step, the per-step tile
computation (a torch function that ``torch.fx`` can trace — its graph
drives instruction selection), and which tiles are DMA'd out.  Block sizes come from the
autotuner (§3.1 hierarchical search), so one kernel yields one spec per
candidate configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileIO:
    """One tile moved between HBM and VMEM each grid step.

    ``invariant`` tiles keep the same HBM address every step (weights,
    norm scales): their address registers are defined in the prologue
    *before* the loop label — which is exactly what makes the paper's
    denylist non-empty (§3.2: defs across labels are unresolvable).
    """
    name: str
    shape: Tuple[int, ...]
    dtype: str = "bf16"
    invariant: bool = False

    @property
    def itemsize(self) -> int:
        return {"bf16": 2, "f32": 4, "f16": 2, "i8": 1, "i32": 4}[self.dtype]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.itemsize


@dataclasses.dataclass
class KernelSpec:
    name: str
    tile_fn: Callable                      # (*input tiles) -> tuple(outputs)
    inputs: List[TileIO]
    outputs: List[TileIO]
    steps: int = 3                         # inner-loop iterations to materialize
    accumulate: bool = False               # outputs stored only on last step
    epilogue_fn: Optional[Callable] = None  # applied to accumulators at the end
    config: Dict = dataclasses.field(default_factory=dict)
    flops_per_step: int = 0

    def describe(self) -> str:
        ins = ", ".join(f"{t.name}{list(t.shape)}" for t in self.inputs)
        outs = ", ".join(f"{t.name}{list(t.shape)}" for t in self.outputs)
        return (f"{self.name}[{self.config}] steps={self.steps} "
                f"in=({ins}) out=({outs})")
