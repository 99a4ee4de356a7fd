"""Learning-rate schedules (linear warmup + cosine decay) — the port of
``repro.optim.schedule``, in f32 as there."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10000,
                  floor: float = 0.1):
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (floor + (1.0 - floor) * cos)
