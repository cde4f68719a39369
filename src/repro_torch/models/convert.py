"""Parameter transfer from the JAX package.

Torch cannot replay JAX's PRNG streams, so the port is held against the
reference by carrying the reference's parameters across:
``params_from_jax(jax.tree.map(np.asarray, params), cfg)`` returns the
port's parameter dict — the same nested keys and the same stacked
``layers`` leaves — and a port model built from it computes what the JAX
model computes.  This module takes numpy arrays only; it imports nothing
of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import model_spec
from repro_torch.nn.core import ParamSpec, torch_dtype


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16 from jax
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(dtype).contiguous()


def params_from_jax(tree: Dict, cfg: ModelConfig) -> Dict:
    """The JAX parameter tree (numpy leaves) as the port's parameters.

    Every leaf is checked against :func:`repro_torch.models.lm.model_spec`
    — a missing, extra or misshapen leaf raises — and converted to
    ``cfg.dtype`` on the CPU."""
    dtype = torch_dtype(cfg.dtype)

    def walk(spec, node, path):
        if isinstance(spec, ParamSpec):
            shape = tuple(np.shape(node))
            if shape != tuple(spec.shape):
                raise ValueError(f"params_from_jax: {path} has shape {shape}, "
                                 f"the spec wants {tuple(spec.shape)}")
            return _tensor(node, dtype)
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"params_from_jax: {path or 'root'} has keys "
                             f"{got}, the spec wants {sorted(spec)}")
        return {k: walk(spec[k], node[k], f"{path}/{k}") for k in sorted(spec)}

    return walk(model_spec(cfg), tree, "")
