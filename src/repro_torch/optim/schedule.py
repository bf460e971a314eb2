"""Learning-rate schedules (port of ``repro.optim.schedule``): functions of
the int32 step tensor that return an f32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return f
