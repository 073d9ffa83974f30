"""LR schedules (pure functions of the step; the JAX package's
``optim/schedule.py``).  Computed in f32 tensors, as the reference does, on
the device of ``step`` when it is a tensor."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, warmup: int = 200, total: int = 10_000, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak. Returns a scale
    (a 0-d f32 tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = (step + 1.0) / max(warmup, 1)  # never a zero-LR first step
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
