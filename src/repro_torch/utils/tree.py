"""Small tree utilities over the port's parameter and state trees.

A tree is a dict (children in sorted-key order), a tuple, list or
NamedTuple (children in order), ``None`` (no leaves), or a leaf (a
tensor, an array or a number).  That is the order ``jax.tree.flatten``
gives the same structure, so a checkpoint's leaf list means the same in
both packages (:mod:`repro_torch.ckpt.checkpoint`).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence

import torch

# Elements per piece when a large leaf is reduced or updated piecewise
# (bounds the f32 temporaries of a bf16 leaf; 256 MB in f32).
PIECE_ELEMS = 1 << 26


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def tree_leaves(tree) -> List:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like, leaves: Sequence):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("tree_unflatten: too few leaves") from None

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: too many leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def pieces(x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``x`` along its first axis of at most about
    ``PIECE_ELEMS`` elements each (``x`` itself when it is small)."""
    if x.ndim == 0 or x.numel() <= PIECE_ELEMS:
        yield x
        return
    rows = max(1, PIECE_ELEMS // max(1, x[0].numel()))
    yield from torch.split(x, rows, dim=0)


def sum_squares(tree) -> torch.Tensor:
    """f32 sum of squared entries over every leaf (0. for empty trees)."""
    total = None
    for x in tree_leaves(tree):
        for part in pieces(x):
            s = torch.sum(torch.square(part.float()))
            total = s if total is None else total + s
    return torch.zeros(()) if total is None else total


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum_squares(tree))


def clip_by_global_norm(tree, max_norm):
    """(the tree scaled by min(1, max_norm / norm), in f32; the norm) — f32
    as in the reference, where a bf16 leaf times the f32 scale promotes."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x.float() * scale, tree), norm


def param_count(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
