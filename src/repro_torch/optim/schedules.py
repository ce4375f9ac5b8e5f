"""Learning-rate schedules, the port of ``repro.optim.schedules``."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1] as a float32 tensor: linear warmup, then
    cosine decay. It is 0 at ``step == 0``, so a trainer's first step
    moves only the optimizer's moments."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
