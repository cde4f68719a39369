"""Weights drawn from the seed on the device, in a few large calls.

One ``torch.randn`` on a ``torch.Generator`` of the device, seeded with
``--seed``, fills every normal leaf in :func:`portbench.layout.leaves`
order, in the type the configuration trains in; each leaf is then scaled
by its own standard deviation (one multiply a leaf, in place).  Norm
scales are ones.  Drawing again with the same seed, device and type gives
the same bits, which is how the reference gets the program's starting
point without reading anything the program made.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.layout import Leaf


def draw(leaves: List[Leaf], seed: int, dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    """{leaf name: tensor of the leaf's shape} for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [leaf for leaf in leaves if leaf.init == "normal"]
    flat = torch.randn(sum(leaf.numel for leaf in normal), generator=gen,
                       dtype=dtype, device=device)
    out, at = {}, 0
    for leaf in leaves:
        if leaf.init == "ones":
            out[leaf.name] = torch.ones(leaf.shape, dtype=dtype,
                                        device=device)
            continue
        view = flat[at:at + leaf.numel].view(leaf.shape)
        at += leaf.numel
        if leaf.std != 1.0:
            view.mul_(leaf.std)
        out[leaf.name] = view
    return out


def _at(tree: Dict, path) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return 1


def load_into(params: Dict, leaves: List[Leaf],
              drawn: Dict[str, torch.Tensor]) -> None:
    """Copy the drawn weights into the program's parameter tree, leaf by
    path.  The tree must hold exactly these leaves at these shapes."""
    if _count(params) != len(leaves):
        raise ValueError(f"the program's tree has {_count(params)} "
                         f"leaves, the layout {len(leaves)}")
    with torch.no_grad():
        for leaf in leaves:
            dst = _at(params, leaf.path)
            if tuple(dst.shape) != leaf.shape:
                raise ValueError(f"{leaf.name}: the program's shape "
                                 f"{tuple(dst.shape)}, the layout's "
                                 f"{leaf.shape}")
            dst.copy_(drawn[leaf.name])


def leaf_of(tree: Dict, leaf: Leaf) -> torch.Tensor:
    return _at(tree, leaf.path)
