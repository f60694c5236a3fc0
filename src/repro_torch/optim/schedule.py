"""Learning-rate schedules, PyTorch port of ``repro.optim.schedule``: each
takes the optimizer's step as an int32 0-d tensor and returns the rate as
a float32 0-d tensor on the step's device."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.1):
    def lr(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup_steps, 1)
        frac = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi
                                                                  * frac)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr


def constant(value: float):
    def lr(step):
        return torch.full((), value, dtype=torch.float32, device=step.device)

    return lr
