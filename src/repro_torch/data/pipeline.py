"""Synthetic data streams, ported from ``repro.data.pipeline``.

Every worker sees the whole task with its own draws (paper Sec 4.1).  The
fixed structure of each task comes from numpy's ``default_rng(seed)``, so
it is bitwise the JAX package's: the LM stream's Markov transition logits
and the image stream's class prototypes.  The draws (tokens, labels,
noise) come from a ``torch.Generator`` on the stream's device; their values
differ from ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


# --------------------------------------------------------------- LM streams

@dataclasses.dataclass(frozen=True)
class LMTaskStream:
    """Order-1 Markov-chain token stream (fixed random transition matrix).

    The (V, V) f32 transition logits live on the stream's device once
    drawn (4.1 GB at V = 32000, and tens of seconds of numpy on the host):
    ``reshaped`` gives another batch shape over the same chain without
    drawing them again."""

    vocab_size: int
    seq_len: int
    batch_size: int
    concentration: float = 0.3  # lower = more predictable
    seed: int = 1234
    device: Any = "cuda"   # the card unless the caller names the CPU

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def transition_logits(self) -> np.ndarray:
        """(V, V) f32, bitwise the JAX package's."""
        rng = np.random.default_rng(self.seed)
        logits = rng.gumbel(size=(self.vocab_size, self.vocab_size))
        logits /= self.concentration
        return logits.astype(np.float32)

    @functools.cached_property
    def _logits(self) -> torch.Tensor:
        return torch.as_tensor(self.transition_logits(), device=self.device)

    def reshaped(self, **shape) -> "LMTaskStream":
        """This chain with another ``seq_len`` / ``batch_size``, sharing the
        transition logits already on the device."""
        out = dataclasses.replace(self, **shape)
        if "_logits" in self.__dict__:
            out.__dict__["_logits"] = self._logits
        return out

    def sample_workers(self, generator: torch.Generator, n: int) -> dict:
        """One batch per worker: {"inputs": (n, B, S), "labels": (n, B, S)}
        int64.  Each next token is a Gumbel-max draw from its row of the
        transition logits (what ``jax.random.categorical`` computes)."""
        rows = n * self.batch_size
        tok = torch.randint(0, self.vocab_size, (rows,), generator=generator,
                            device=self.device)
        seq = [tok]
        tiny = torch.finfo(torch.float32).tiny
        for _ in range(self.seq_len):
            u = torch.rand((rows, self.vocab_size), generator=generator,
                           device=self.device).clamp_min_(tiny)
            tok = (self._logits[tok] - torch.log(-torch.log(u))).argmax(-1)
            seq.append(tok)
        seq = torch.stack(seq, dim=1).reshape(n, self.batch_size,
                                              self.seq_len + 1)
        return {"inputs": seq[..., :-1], "labels": seq[..., 1:]}

    def sample(self, generator: torch.Generator) -> dict:
        """Returns {"inputs": (B,S), "labels": (B,S)} int64."""
        batch = self.sample_workers(generator, 1)
        return {k: v[0] for k, v in batch.items()}

    def bayes_ce(self) -> float:
        """Entropy rate of the chain = minimum achievable CE (numpy, the
        JAX package's arithmetic step for step)."""
        logits = self.transition_logits()
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        # stationary distribution via power iteration
        pi = np.full(self.vocab_size, 1.0 / self.vocab_size)
        for _ in range(200):
            pi = pi @ p
        h = -np.sum(pi[:, None] * p * np.log(np.maximum(p, 1e-12)))
        return float(h)


def make_lm_stream(cfg, seq_len: int, batch_size: int, seed: int = 1234,
                   device="cuda") -> LMTaskStream:
    return LMTaskStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        batch_size=batch_size, seed=seed, device=device)


def lm_batch_specs(vocab: int, batch: int, seq: int) -> dict:
    """An LM batch's int32 (batch, seq) inputs and labels on the meta
    device: shapes and dtypes, no storage (the dry run's stand-ins)."""
    return {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for k in ("inputs", "labels")}


# ------------------------------------------------------------ image streams

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


# ------------------------------------------------------------- worker views

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    """SplitMix64's step and finalizer on a 64-bit integer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class WorkerStream:
    """Per-worker data stream: same task, a worker-specific random stream.

    Mirrors the paper's protocol: all workers access the same dataset but
    shuffle with different seeds — i.i.d. in distribution, independent in
    realization.  ``key(worker_id, step)`` is a ``torch.Generator`` on the
    stream's device seeded by

        s = splitmix64(splitmix64(splitmix64(base_seed) ^ worker_id) ^ step)

    (64-bit integers; ``splitmix64`` is SplitMix64's step and finalizer),
    where the JAX package folds ``worker_id`` and then ``step`` into a
    ``PRNGKey(base_seed)``: the same structure, other draws."""

    base_seed: int = 0
    device: Any = "cuda"   # the card unless the caller names the CPU

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def key(self, worker_id: int, step: int) -> torch.Generator:
        h = _splitmix64(int(self.base_seed) & _MASK64)
        h = _splitmix64(h ^ (int(worker_id) & _MASK64))
        h = _splitmix64(h ^ (int(step) & _MASK64))
        return torch.Generator(device=self.device).manual_seed(h)
