"""Step functions, ported from ``repro.launch.steps``: the prefill step.

The JAX package's ``forward_only()`` context is a sharding hint; here the
forward runs under ``torch.no_grad()``, which keeps no graph (and lets the
flash kernel, which has no backward, run).  The train and serve steps wait
for the optimizers and the decode path.
"""
from __future__ import annotations

import torch

from ..models.transformer import Model


def make_prefill_step(model: Model):
    def prefill_step(params: dict, batch: dict):
        with torch.no_grad():
            logits, _, _ = model.forward(params, batch["inputs"])
        return logits

    return prefill_step
