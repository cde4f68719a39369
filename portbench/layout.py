"""The parameter layout of a configuration file, leaf by leaf.

A leaf is named by its path in the port's parameter tree (nested dicts,
layers stacked on a leading axis) and carries its shape, how it is drawn
and whether AdamW decays it.  The benchmark draws every leaf from the
seed in this order (:mod:`portbench.weights`), hands the same values to
the program and to the reference, and compares the two leaf by leaf,
each stacked leaf cut into its layers (:func:`per_layer_names`).

The layout is written from the configuration's published keys alone, by
the model type's module under ``portbench/reference/``: nothing of it is
read from the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]   # stacked leaves: (layers, *per-layer shape)
    init: str                # "normal" (std below) or "ones"
    std: float
    layers: int              # 0 for a leaf that is not stacked

    @property
    def name(self) -> str:
        return ".".join(self.path)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def decays(self) -> bool:
        """AdamW's weight decay as the port's optimizer applies it: every
        leaf of rank two or more in the stacked tree, so a layer's norm
        scale decays and the final norm's does not."""
        return len(self.shape) >= 2


def normal(path, shape, fan_in, layers=0) -> Leaf:
    return Leaf(tuple(path), tuple(shape), "normal", fan_in ** -0.5, layers)


def ones(path, shape, layers=0) -> Leaf:
    return Leaf(tuple(path), tuple(shape), "ones", 0.0, layers)


def stack(leaves: List[Leaf], prefix: str, n: int) -> List[Leaf]:
    """``leaves`` of one layer stacked over ``n`` layers under ``prefix``."""
    return [dataclasses.replace(leaf, path=(prefix,) + leaf.path,
                                shape=(n,) + leaf.shape, layers=n)
            for leaf in leaves]


def swiglu(prefix: Tuple[str, ...], d: int, f: int) -> List[Leaf]:
    return [normal(prefix + ("gate", "w"), (d, f), d),
            normal(prefix + ("up", "w"), (d, f), d),
            normal(prefix + ("down", "w"), (f, d), f)]


def block(c: Dict, attention: List[Leaf], ffn: List[Leaf]) -> List[Leaf]:
    """A pre-norm decoder layer: ``ln1``, ``attn``, ``ln2`` and its
    feed-forward leaves."""
    d = c["hidden_size"]
    return ([ones(("ln1", "scale"), (d,))] + attention
            + [ones(("ln2", "scale"), (d,))] + ffn)


def top(c: Dict) -> List[Leaf]:
    """The embedding, the final norm and (untied) the head."""
    d, vocab = c["hidden_size"], c["vocab_size"]
    out = [Leaf(("embed", "table"), (vocab, d), "normal", 1.0, 0),
           ones(("final_norm", "scale"), (d,))]
    if not c.get("tie_word_embeddings", False):
        out.append(normal(("lm_head", "out", "w"), (d, vocab), d))
    return out


def leaves(c: Dict) -> List[Leaf]:
    """Every leaf of configuration ``c`` (its file's keys), in the order
    the weights are drawn: sorted by path.  The model type's module under
    ``portbench/reference/`` lists them."""
    from portbench.reference import model
    return sorted(model.family(c).leaves(c), key=lambda leaf: leaf.path)


def per_layer_names(leaf: Leaf) -> List[str]:
    """The names under which a leaf is compared: ``layers.3.attn.wq.w``
    for layer 3 of a stacked leaf, the path itself otherwise."""
    if not leaf.layers:
        return [leaf.name]
    head, rest = leaf.path[0], ".".join(leaf.path[1:])
    return [f"{head}.{i}.{rest}" for i in range(leaf.layers)]
