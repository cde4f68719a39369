"""The reference's training steps: the same weights and batches as the
program, the loss and gradients of the model type's ``Model``
in float32, and AdamW.

AdamW as the configuration's mix file states it: float32 moments,
gradients clipped to a global norm, bias correction, decoupled weight
decay on the leaves :attr:`portbench.layout.Leaf.decays` names, a linear
warm-up then a cosine to ``min_frac`` of the rate.  The parameters are
stored in the configuration's type (bfloat16): each update is computed
in float32 and rounded once to that type, as a model stored in it is
updated.

:func:`follow` returns what the check compares: each step's loss, each
leaf's gradient norm at the first step (before clipping), and each
leaf's change after the last step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from portbench import data, layout, weights
from portbench.reference import model as ref_model


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]      # first step, before clipping
    change_norms: Dict[str, float]    # after the last step


def learning_rate(opt: Dict, step: int) -> float:
    lr, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (opt["min_frac"] + (1 - opt["min_frac"]) * 0.5
                 * (1 + math.cos(math.pi * t)))


def per_layer(leaves, drawn) -> Dict[str, torch.Tensor]:
    out = {}
    for leaf in leaves:
        t = drawn[leaf.name]
        parts = t.unbind(0) if leaf.layers else [t]
        out.update(zip(layout.per_layer_names(leaf), parts))
    return out


def batch_tensors(seed: int, step: int, mix: Dict, vocab: int, device):
    b = data.batch_at(seed, step, mix["batch"], mix["seq_len"], vocab)
    return (torch.from_numpy(b["tokens"]).to(device),
            torch.from_numpy(b["labels"]).to(device))


def follow(c: Dict, mix: Dict, seed: int, device, steps: int,
           store: torch.dtype, mm=ref_model.exact_mm) -> Readings:
    """``steps`` training steps of configuration ``c`` from the weights
    of ``seed`` on the batches of ``seed``, steps 0 to ``steps - 1``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(c, mix, seed, device, steps, store, mm)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _follow(c, mix, seed, device, steps, store, mm) -> Readings:
    opt = mix["optimizer"]
    leaves = layout.leaves(c)
    decays = {name: leaf.decays for leaf in leaves
              for name in layout.per_layer_names(leaf)}
    drawn = weights.draw(leaves, seed, store, device)
    params = {n: t.to(torch.float32, copy=True).requires_grad_()
              for n, t in per_layer(leaves, drawn).items()}
    del drawn
    model = ref_model.build(c, mm)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        tokens, labels = batch_tensors(seed, step - 1, mix, c["vocab_size"],
                                       device)
        loss = model.loss(params, tokens, labels)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            if step == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(g))
                              for n, g in grads.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            clip = torch.clamp(opt["max_grad_norm"] / (norm + 1e-12),
                               max=1.0)
            lr = learning_rate(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n, p in params.items():
                g = grads[n] * clip
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g * g)
                u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
                if decays[n]:
                    u = u + opt["weight_decay"] * p
                p.sub_(lr * u)
                p.copy_(p.to(store))
                p.grad = None
            del grads
    del mu, nu
    start = per_layer(leaves, weights.draw(leaves, seed, store, device))
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - start[n].float()))
                  for n, p in params.items()}
    return Readings(losses, grad_norms, change)
