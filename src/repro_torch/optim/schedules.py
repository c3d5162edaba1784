"""Learning-rate schedules (pure functions of the step counter) —
``repro.optim.schedules``, in float32 as there.  The step may be an int or
a tensor; the rate is a 0-dim float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then cosine decay to
    ``min_frac * base_lr`` at ``total``.  The rate at step 0 is 0 whenever
    ``warmup >= 1``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def constant(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
