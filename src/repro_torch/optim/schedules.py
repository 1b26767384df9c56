"""Learning-rate schedules: step -> 0-dim float32 tensor on the CPU.

Counterpart of ``repro/optim/schedules.py``, computed in float32 as
``jnp`` computes it. A 0-dim CPU tensor enters device arithmetic as a
scalar, without a copy or a sync.
"""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


def constant_lr(lr: float):
    return lambda step: _f32(lr)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    to ``final_frac * peak_lr`` at ``total_steps``."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / _f32(max(warmup_steps, 1))
        prog = torch.clamp((step - warmup_steps)
                           / _f32(max(total_steps - warmup_steps, 1)), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return sched
