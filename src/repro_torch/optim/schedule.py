"""LR schedules (port of ``repro/optim/schedule.py``): functions of the
step counter, computed in f32 on the counter's device, so a schedule
inside the train step needs no host sync."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1
                  ) -> torch.Tensor:
    t = _f32(step)
    warm = peak_lr * t / max(warmup_steps, 1)
    frac = torch.clamp((t - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_f32(step), peak_lr)
