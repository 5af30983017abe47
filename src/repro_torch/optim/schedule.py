"""LR schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor * peak`` at ``total``; a function of the step (a tensor, in
    float32) returning a float32 scalar tensor."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
