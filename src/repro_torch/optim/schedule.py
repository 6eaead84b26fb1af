"""Learning-rate schedules (the reference's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10000,
                    floor: float = 0.1) -> torch.Tensor:
    """The learning-rate scale at ``step`` (a tensor or an int), float32:
    a linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` by ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * (floor + (1 - floor) * cos)
