"""LR schedules (the port of ``repro/optim/schedule.py``): pure functions
of the step counter."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, *, warmup: int = 100, total: int = 10000,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak: a f32 scale in
    [0, 1] for the configured peak LR, on ``step``'s device."""
    s = step.to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)
