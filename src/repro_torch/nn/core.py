"""Functional NN substrate: parameters are nested dicts of tensors (the
JAX package's pytrees, leaf for leaf), modules are (spec, apply) function
pairs.  Keeping the JAX layout makes parameter transfer from the
reference a leaf-by-leaf copy (see :mod:`repro_torch.models.convert`).

Every parameter leaf carries *logical axes* in its :class:`ParamSpec`, as
in the reference; nothing in the port maps them to devices yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import matmul

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``cfg.dtype``) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


@dataclasses.dataclass
class ParamSpec:
    """Shape + logical axis names + initializer for one parameter leaf."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None

    def make(self, generator: torch.Generator, dtype: torch.dtype,
             device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) >= 2 else max(self.shape[0], 1)
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        if self.init == "embed":
            scale = self.scale if self.scale is not None else 1.0
        w = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)


def _map_specs(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, specs[k]) for k in sorted(specs)}


def init_params(specs: Dict, generator: torch.Generator,
                dtype=torch.float32) -> Dict:
    """Instantiate a (nested) dict of ParamSpec into tensors on the
    generator's device, drawing the leaves in sorted-key order."""
    dtype = torch_dtype(dtype)
    return _map_specs(lambda s: s.make(generator, dtype, generator.device),
                      specs)


def stack_specs(specs: Dict, n: int, axis_name: str = "layers") -> Dict:
    """Stack a per-layer spec tree along a leading 'layers' dimension (the
    reference's scan-over-layers layout; decode indexes layer ``i`` as a
    view)."""
    return _map_specs(lambda s: ParamSpec((n,) + s.shape,
                                          (axis_name,) + s.axes,
                                          s.init, s.scale), specs)


def dense(d_in: int, d_out: int, axes=("embed", "mlp"),
          bias: bool = False, name: str = "w") -> Dict:
    spec = {name: ParamSpec((d_in, d_out), axes)}
    if bias:
        spec[name + "_b"] = ParamSpec((d_out,), (axes[-1],), "zeros")
    return spec


def apply_dense(p: Dict, x: torch.Tensor, name: str = "w") -> torch.Tensor:
    y = matmul(x, p[name].to(x.dtype))
    if name + "_b" in p:
        y = y + p[name + "_b"].to(x.dtype)
    return y
