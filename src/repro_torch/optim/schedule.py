"""Learning-rate schedules (step -> lr): f32 0-d tensors on the step's
device, computed as the reference computes them in f32."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_schedule(lr: float, total_steps: int, end_frac: float = 0.0):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return lr * ((1.0 - t) + t * end_frac)
    return f


def cosine_schedule(lr: float, total_steps: int, min_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (min_frac + (1.0 - min_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = lr * (min_frac + (1.0 - min_frac) * 0.5
                    * (1.0 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return f
