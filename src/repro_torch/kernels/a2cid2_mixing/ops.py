"""Dispatch between the hand kernel and its plain PyTorch version.

The backend follows the tensor: a CUDA tensor launches the Hopper kernel
(or the call raises; there is no fallback), a CPU tensor takes the plain
version in ``ref.py``.  ``backend="ref"`` forces the plain version on any
device; ``chip_smoke.py`` uses it to hold the kernel against it on the
card.
"""
from __future__ import annotations

import torch

from .kernel import mixing_gossip_stacked
from .ref import mixing_gossip_stacked_ref


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for a CUDA tensor, 'ref' for a CPU tensor; 'ref'
    passes through."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    if backend != "ref":
        raise ValueError(f"unknown backend {backend!r}, have 'auto', 'ref'")
    return backend


def gossip_event_stacked(x: torch.Tensor, x_tilde: torch.Tensor,
                         partner: torch.Tensor, dt_next: torch.Tensor, *,
                         eta: float, alpha: float, alpha_t: float,
                         backend: str = "auto"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused coalesced gossip batch on worker-stacked (W, D) buffers.

    Callers use the returned pair and treat ``x_tilde`` as consumed: the
    CUDA kernel writes it in place, the plain version returns a new one.
    """
    if resolve_backend(backend, x) == "ref":
        return mixing_gossip_stacked_ref(x, x_tilde, partner, dt_next,
                                         eta=eta, alpha=alpha,
                                         alpha_t=alpha_t)
    return mixing_gossip_stacked(x, x_tilde, partner, dt_next, eta=eta,
                                 alpha=alpha, alpha_t=alpha_t)
