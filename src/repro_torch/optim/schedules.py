"""Learning-rate schedules: step (a tensor) -> f32 learning rate (a
tensor on the step's device).

``goyal_warmup_step_decay`` is the paper's schedule (Sec 4.1): linear
warmup scaling the base LR by the worker count (large-batch rule of Goyal
et al. [16]) followed by x0.1 step decays at fixed epoch milestones.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def goyal_warmup_step_decay(base_lr: float, n_workers: int,
                            steps_per_epoch: int,
                            milestones: Sequence[int] = (30, 60, 80),
                            warmup_epochs: int = 5,
                            total_epochs: int = 90) -> Schedule:
    """LR = base * n_workers after warmup; /10 at each milestone epoch."""
    peak = base_lr * n_workers
    warm = warmup_epochs * steps_per_epoch

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm_lr = base_lr + (peak - base_lr) * torch.clamp(step / warm,
                                                          max=1.0)
        decay = torch.ones((), dtype=torch.float32, device=step.device)
        for m in milestones:
            decay = decay * torch.where(step >= m * steps_per_epoch, 0.1,
                                        1.0)
        return warm_lr * decay

    return sched


def cosine(peak_lr: float, warmup_steps: int, total_steps: int,
           final_frac: float = 0.1) -> Schedule:
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return sched
