"""Synthetic CIFAR-like data, ported from ``repro.data.pipeline``.

Every worker sees the whole task with its own draws (paper Sec 4.1).  The
class prototypes come from numpy's ``default_rng(seed)``, so they are
bitwise the JAX package's; labels and noise come from a ``torch.Generator``
on the stream's device (the values differ from ``jax.random``'s).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticCIFAR:
    """CIFAR-like stream: Gaussian class prototypes + noise (32x32x3 NHWC)."""

    num_classes: int = 10
    batch_size: int = 128
    noise: float = 0.6
    seed: int = 7
    device: Any = "cuda"   # the card unless the caller names the CPU

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @functools.cached_property
    def _protos(self) -> torch.Tensor:
        return torch.as_tensor(self.prototypes(), device=self.device)

    def prototypes(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.normal(size=(self.num_classes, 32, 32, 3)).astype(
            np.float32)

    def sample_workers(self, generator: torch.Generator, n: int) -> dict:
        """One batch per worker: images (n, B, 32, 32, 3), labels (n, B)."""
        shape = (n, self.batch_size)
        labels = torch.randint(0, self.num_classes, shape,
                               generator=generator, device=self.device)
        noise = torch.randn(shape + (32, 32, 3), generator=generator,
                            device=self.device)
        return {"images": self._protos[labels] + self.noise * noise,
                "labels": labels}

    def sample(self, generator: torch.Generator) -> dict:
        """One batch: images (B, 32, 32, 3), labels (B,)."""
        batch = self.sample_workers(generator, 1)
        return {k: v[0] for k, v in batch.items()}
