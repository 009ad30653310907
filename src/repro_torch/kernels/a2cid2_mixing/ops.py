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
                     mixing_gossip_stacked, mixing_gossip_worlds, mixing_p2p,
                     p2p_mixing)
from .ref import (channel_gossip_stacked_ref, channel_gossip_worlds_ref,
                  channel_p2p_mixing_ref, mixing_gossip_stacked_ref,
                  mixing_gossip_worlds_ref, mixing_p2p_ref, p2p_mixing_ref)


def _scalar_on(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` (a float or a one-element tensor) as one float32 on x's
    device: a tensor already there is a view, not a copy."""
    return torch.as_tensor(v, dtype=torch.float32, device=x.device)


def gossip_event(x: torch.Tensor, x_tilde: torch.Tensor,
                 x_partner: torch.Tensor, dt, *, eta: float, alpha: float,
                 alpha_t: float, backend: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One event on one tensor of any shape, mix then p2p: x, x~ mixed for
    ``dt``, then averaged against the partner's (already mixed) x.  Returns
    fresh tensors of x's shape."""
    dyn = dict(eta=eta, alpha=alpha, alpha_t=alpha_t)
    if resolve_backend(backend, x) == "ref":
        return mixing_p2p_ref(x, x_tilde, x_partner, dt, **dyn)
    return mixing_p2p(x, x_tilde, x_partner, _scalar_on(dt, x), **dyn)


def gossip_event_pytree(x, x_tilde, x_partner, dt, *, eta: float,
                        alpha: float, alpha_t: float, backend: str = "auto"):
    """``gossip_event`` on every leaf of a parameter tree (one launch per
    leaf on the card); leaves keep their shapes.  ``dt`` is moved to the
    leaves' device once for the whole tree."""
    # imported here: repro_torch.core imports this module
    from ...core.tree import tree_flatten
    flat_x, treedef = tree_flatten(x)
    flat_t = treedef.flatten_up_to(x_tilde)
    flat_p = treedef.flatten_up_to(x_partner)
    if flat_x:
        dt = _scalar_on(dt, flat_x[0])
    outs = [gossip_event(a, b, c, dt, eta=eta, alpha=alpha, alpha_t=alpha_t,
                         backend=backend)
            for a, b, c in zip(flat_x, flat_t, flat_p)]
    return (treedef.unflatten([o[0] for o in outs]),
            treedef.unflatten([o[1] for o in outs]))


def p2p_mix_event(x: torch.Tensor, x_tilde: torch.Tensor,
                  x_partner: torch.Tensor, dt_next, *, eta: float,
                  alpha: float, alpha_t: float, backend: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused p2p-then-mix on one worker's flat (D,) vectors (the SPMD
    per-worker path).  ``dt_next`` is one float32 (on the card, a view into
    the event gaps).  ``x_tilde`` is consumed, as in
    ``gossip_event_stacked``."""
    dyn = dict(eta=eta, alpha=alpha, alpha_t=alpha_t)
    if resolve_backend(backend, x) == "ref":
        return p2p_mixing_ref(x, x_tilde, x_partner, dt_next, **dyn)
    return p2p_mixing(x, x_tilde, x_partner, _scalar_on(dt_next, x), **dyn)


def channel_event_local(x: torch.Tensor, x_tilde: torch.Tensor,
                        x_partner: torch.Tensor, corrupt, mscale, dt_next,
                        *, eta: float, alpha: float, alpha_t: float,
                        clip: float | None = None, backend: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel variant of ``p2p_mix_event`` on one worker's (D,) vectors
    (the SPMD path): one f32 ``corrupt``, ``mscale`` and ``dt_next`` for
    this worker's read.  The card runs ``channel_gossip_stacked`` on a
    (1, D) view, as the JAX package runs its Pallas kernel.  ``x_tilde`` is
    consumed."""
    kw = dict(eta=eta, alpha=alpha, alpha_t=alpha_t, clip=clip)
    if resolve_backend(backend, x) == "ref":
        return channel_p2p_mixing_ref(x, x_tilde, x_partner, corrupt,
                                      mscale, dt_next, **kw)
    ox, ot = channel_gossip_stacked(
        x[None], x_tilde[None], x_partner[None],
        _scalar_on(corrupt, x).reshape(1), _scalar_on(mscale, x).reshape(1),
        _scalar_on(dt_next, x).reshape(1), **kw)
    return ox[0], ot[0]


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
