"""Optimizers with the reference's functional contract::

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

All moments are kept in float32 regardless of parameter dtype (mixed
precision training keeps bf16 params + f32 optimizer state).

One departure, for memory: ``update`` writes the new moments into the
state's tensors in place and returns a state that holds them, where the
reference returns new arrays (its train step donates the old state, so
XLA reuses those buffers too).  A caller must not read the old state's
moments after ``update``.  Large leaves are updated a piece at a time
(:func:`repro_torch.utils.tree.pieces`), which bounds the f32
temporaries; the arithmetic is elementwise, so the result is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.utils.tree import (global_norm, pieces, tree_leaves,
                                    tree_map, tree_unflatten)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    # clip threshold applied inside ``update`` (None = no clipping)
    max_grad_norm: Optional[float] = None


def _as_schedule(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _split(x: torch.Tensor, like: torch.Tensor):
    """``x`` cut along its first axis exactly as ``pieces(like)`` cuts."""
    parts = list(pieces(like))
    if len(parts) == 1:
        return [x]
    return torch.split(x, parts[0].shape[0], dim=0)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, max_grad_norm: Optional[float] = None,
          mask: Optional[Callable] = None) -> Optimizer:
    """AdamW with decoupled weight decay and optional global-norm clipping.

    ``mask(params)`` returns a tree of bools selecting parameters that
    receive weight decay (convention: 2D+ weights yes, biases/norm scales
    no)."""
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(step=_step0(params), mu=_zeros_f32(params),
                         nu=_zeros_f32(params))

    def update(grads, state, params):
        step = state.step + 1
        clip = None
        if max_grad_norm is not None:
            clip = torch.clamp(max_grad_norm / (global_norm(grads) + 1e-12),
                               max=1.0)
        t = step.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        lr_t = sched(step)
        wd_mask = (tree_leaves(mask(params)) if mask is not None
                   else [p.ndim >= 2 for p in tree_leaves(params)])
        updates = []
        for g, m, v, p, use_wd in zip(tree_leaves(grads),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu),
                                      tree_leaves(params), wd_mask):
            upd = torch.empty_like(p)
            for gp, mp, vp, pp, up in zip(*(_split(x, p)
                                            for x in (g, m, v, p, upd))):
                g32 = gp.float()
                if clip is not None:
                    g32 = g32 * clip
                mp.copy_(b1 * mp + (1 - b1) * g32)
                vp.copy_(b2 * vp + (1 - b2) * g32 * g32)
                mu_hat, nu_hat = mp / bc1, vp / bc2
                if weight_decay:
                    u = mu_hat / (torch.sqrt(nu_hat) + eps)
                    if use_wd:
                        u = u + weight_decay * pp.float()
                    up.copy_(-lr_t * u)
                else:
                    up.copy_(-lr_t * mu_hat / (torch.sqrt(nu_hat) + eps))
            updates.append(upd)
        return (tree_unflatten(params, updates),
                AdamState(step=step, mu=state.mu, nu=state.nu))

    return Optimizer(init=init, update=update, max_grad_norm=max_grad_norm)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-5,
         max_grad_norm: Optional[float] = None) -> Optimizer:
    """Plain Adam with the PPO-standard eps=1e-5 (37-details study)."""
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0,
                 max_grad_norm=max_grad_norm)


def sgd_momentum(lr, momentum: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(step=_step0(params), mu=_zeros_f32(params), nu=None)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(step)
        updates = []
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                           tree_leaves(params)):
            m.copy_(momentum * m + g.float())
            updates.append((-lr_t * m).to(p.dtype))
        return (tree_unflatten(params, updates),
                AdamState(step=step, mu=state.mu, nu=None))

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
