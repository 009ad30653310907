"""Dispatch between the hand kernels and their plain PyTorch versions.

The backend follows the tensor: a CUDA tensor launches the Hopper kernel
(or the call raises; there is no fallback), a CPU tensor takes the plain
version in ``ref.py``.  ``backend="ref"`` forces the plain version on any
device; ``chip_smoke.py`` uses it to hold the kernel against it on the
card.
"""
from __future__ import annotations

import torch

from .. import resolve_backend
from .kernel import (channel_gossip_stacked, channel_gossip_worlds,
                     mixing_gossip_stacked, mixing_gossip_worlds)
from .ref import (channel_gossip_stacked_ref, channel_gossip_worlds_ref,
                  mixing_gossip_stacked_ref, mixing_gossip_worlds_ref)


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


def channel_event_stacked(x: torch.Tensor, x_tilde: torch.Tensor,
                          x_partner: torch.Tensor, corrupt: torch.Tensor,
                          mscale: torch.Tensor, dt_next: torch.Tensor, *,
                          eta: float, alpha: float, alpha_t: float,
                          clip: float | None = None, want_rej: bool = False,
                          backend: str = "auto"):
    """Fused channel gossip batch on (W, D) buffers: pre-gathered partner
    values, per-worker ``corrupt`` multiplier offsets, per-worker robust
    ``mscale`` (norm trim/clip), optional coordinate ``clip``; with
    ``want_rej`` also the (W,) rejection mask.  ``x_tilde`` is consumed,
    as in ``gossip_event_stacked``."""
    kw = dict(eta=eta, alpha=alpha, alpha_t=alpha_t, clip=clip,
              want_rej=want_rej)
    if resolve_backend(backend, x) == "ref":
        return channel_gossip_stacked_ref(x, x_tilde, x_partner, corrupt,
                                          mscale, dt_next, **kw)
    return channel_gossip_stacked(x, x_tilde, x_partner, corrupt, mscale,
                                  dt_next, **kw)


def gossip_event_worlds(x: torch.Tensor, x_tilde: torch.Tensor,
                        partner: torch.Tensor, dt_next: torch.Tensor,
                        eta: torch.Tensor, alpha: torch.Tensor,
                        alpha_t: torch.Tensor, *, backend: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused coalesced gossip batch over B worlds: (B, W, D) buffers,
    (B, W) partners and dt, (B,) per-world dynamics (baseline and A2CiD2
    worlds in one launch).  ``x_tilde`` is consumed, as in
    ``gossip_event_stacked``."""
    if resolve_backend(backend, x) == "ref":
        return mixing_gossip_worlds_ref(x, x_tilde, partner, dt_next, eta,
                                        alpha, alpha_t)
    return mixing_gossip_worlds(x, x_tilde, partner, dt_next, eta, alpha,
                                alpha_t)


def channel_event_worlds(x: torch.Tensor, x_tilde: torch.Tensor,
                         x_partner: torch.Tensor, corrupt: torch.Tensor,
                         mscale: torch.Tensor, dt_next: torch.Tensor,
                         eta: torch.Tensor, alpha: torch.Tensor,
                         alpha_t: torch.Tensor, *,
                         clip: float | None = None, want_rej: bool = False,
                         backend: str = "auto"):
    """World-batched channel gossip batch: pre-gathered (B, W, D) partner
    values, (B, W) corrupt, robust mscale and dt, (B,) per-world dynamics,
    the coordinate ``clip``; with ``want_rej`` also the (B, W) rejection
    mask.  ``x_tilde`` is consumed."""
    kw = dict(clip=clip, want_rej=want_rej)
    args = (x, x_tilde, x_partner, corrupt, mscale, dt_next, eta, alpha,
            alpha_t)
    if resolve_backend(backend, x) == "ref":
        return channel_gossip_worlds_ref(*args, **kw)
    return channel_gossip_worlds(*args, **kw)
