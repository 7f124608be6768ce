"""Learning-rate schedules (pure functions of the step counter), the port
of the JAX package's ``optim/schedule.py``: float32 tensors of a step
tensor."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
    return final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi
                                                                      * t))


def linear_warmup_cosine(step: torch.Tensor, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
    decay = cosine_schedule(torch.clamp(s - warmup, min=0.0),
                            max(total_steps - warmup, 1), final_frac)
    return warm * decay
