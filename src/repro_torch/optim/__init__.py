"""Optimizers and schedules."""
from .optimizers import (Optimizer, OptState, adamw, apply_updates,
                         clip_by_global_norm, sgd)
from .schedules import constant, cosine, goyal_warmup_step_decay

__all__ = ["Optimizer", "OptState", "adamw", "apply_updates",
           "clip_by_global_norm", "sgd", "constant", "cosine",
           "goyal_warmup_step_decay"]
