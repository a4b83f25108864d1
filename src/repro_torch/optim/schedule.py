"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of an integer step tensor, computed in float32 as the JAX
versions compute them (``s = step.astype(float32)``, Python constants
weakly typed)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``; a float32
    scalar on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    frac = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float) -> torch.Tensor:
    """``peak_lr`` as a float32 scalar on ``step``'s device."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), peak_lr, dtype=torch.float32, device=dev)


__all__ = ["warmup_cosine", "constant"]
