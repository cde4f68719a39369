"""Train-step construction: loss, gradients, microbatching, the
optimizer update.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``, the
reference's mesh-less step.  Gradients come from autograd over the port's
forward, where the kernels' ``autograd.Function``s stand in for XLA's
autodiff of the reference's jnp code.  The reference's sharded step
(``make_sharded_train_step``, ``init_ef_state``, the ``ef`` residuals) and
a ``mesh`` wait for the port's distribution slice (ROADMAP A14).  The
encoder-decoder's loss runs :func:`repro_torch.models.encdec.forward`
over the batch's ``frames``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import wide
from repro_torch.models import encdec, lm
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.utils.tree import global_norm, tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Dict
    opt_state: object
    step: torch.Tensor
    # the reference's error-feedback residuals of the compressed pod-axis
    # reduction; always None here (ROADMAP A14)
    ef: object = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in f32.  logits (B, S, V); labels (B, S) ints."""
    logp = torch.log_softmax(wide(logits), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.mean()


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    if cfg.family == "encdec":
        logits = encdec.forward(params, batch["frames"], batch["tokens"],
                                cfg, mesh=mesh)
    else:
        logits = lm.forward(params, batch["tokens"], cfg, mesh=mesh)
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}


def compute_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                  num_microbatches: int = 1) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of ``loss_fn`` at ``params``; grads share params'
    structure and dtypes.  ``num_microbatches > 1`` accumulates f32
    gradients over sequential slices of the batch and averages them, as
    the reference's scan does."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)

    def one(b):
        with torch.enable_grad():
            loss, _ = loss_fn(live, b, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if num_microbatches == 1:
        loss, grads = one(batch)
        return loss, tree_unflatten(params, grads)
    loss_sum = torch.zeros((), device=leaves[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    for i in range(num_microbatches):
        micro = {k: v.reshape((num_microbatches, v.shape[0]
                               // num_microbatches) + v.shape[1:])[i]
                 for k, v in batch.items()}
        loss, grads = one(micro)
        loss_sum = loss_sum + loss
        for a, g in zip(acc, grads):
            a.add_(g)
    scale = 1.0 / num_microbatches
    return loss_sum * scale, tree_unflatten(params, [a * scale for a in acc])


def make_train_step(cfg: ModelConfig, opt: Optimizer, mesh=None,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics) with metrics
    ``loss``, ``grad_norm`` (before clipping) and ``step`` as 0-d tensors.
    The optimizer updates the moments of ``state`` in place (see
    :mod:`repro_torch.optim.adamw`): pass each state once."""
    if mesh is not None:
        raise NotImplementedError("make_train_step: mesh is not ported yet; "
                                  "see ROADMAP A14 (distribution)")

    def train_step(state: TrainState, batch: Dict):
        loss, grads = compute_grads(state.params, batch, cfg,
                                    num_microbatches)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step
