"""LR schedules, including the DistillCycle per-stage exponential decay (Eq. 20).

Port of ``repro.optim.schedule``. A schedule maps a step (an int or a 0-d
tensor) to a float32 scale on top of the base learning rate.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos  # scale on top of base lr

    return fn


def constant(scale: float = 1.0) -> Callable:
    return lambda step: torch.tensor(scale, dtype=torch.float32)


def distillcycle_decay(gamma: float, stage: int) -> float:
    """Paper Eq. (20): alpha_t = alpha_0 * gamma^t for earlier-stage layers."""
    return gamma ** stage
