"""Flat-buffer fused gossip-event engine.

The engine owns three ingredients:

  1. a :class:`~repro_torch.core.flatbuf.FlatLayout` packing the replica
     pytree into one contiguous (W, D) buffer,
  2. the fused p2p-then-mix pass from ``repro_torch.kernels.a2cid2_mixing``
     (the Hopper kernel on CUDA tensors, its plain version on the CPU),
  3. the *group* pass structure: the exact per-event sequence

         mix(d_0), S_0, mix(d_1), S_1, ..., S_{K-1}, mix(d_K)

     (S_i a fused comm batch or a gradient tick) regrouped as
     ``[mix(d_0)] [S_0, mix(d_1)] ... [S_{K-1}, mix(d_K)]`` — the same
     composition (the mixing flow is a semigroup), but each bracketed comm
     group is ONE fused sweep reading 3 state-sized buffers and writing 2.

The unreliable-channel passes (``channel_batch``, ``channel_batch_scaled``)
take the partner values pre-gathered (``partner_values``: fresh rows or
snapshot-ring rows) and apply the robust m-term; around the fused kernel
they run plain PyTorch, as the JAX package runs XLA there: the ring
gathers and the ``delta_norms`` reduce.

The local passes (``batch_local``, ``channel_batch_local``, with
``pack_local`` / ``unpack_local``) run one worker's (D,) vectors: the
per-worker event of the SPMD trainer (``core/gossip.py``).

The world-batched passes (``mix_batch``, ``batch_worlds``,
``channel_batch_worlds[_scaled]``, ``partner_values_worlds``) run B
worlds' (B, W, D) buffers at once with the per-world dynamics ``pw =
(eta, alpha, alpha_t)`` as (B,) f32 tensors on the buffers' device, so
baseline and A2CiD2 worlds share one launch.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.a2cid2_mixing.ops import (channel_event_local,
                                         channel_event_stacked,
                                         channel_event_worlds,
                                         gossip_event_stacked,
                                         gossip_event_worlds, p2p_mix_event)
from .a2cid2 import A2CiD2Params, apply_mixing
from .flatbuf import FlatLayout, ring_read, ring_read_worlds
from .tree import PyTree


def norm_scale(nrm: torch.Tensor, tau, rule: str) -> torch.Tensor:
    """Per-worker robust scale from the delta norms under a norm rule:
    'trim' rejects (0) a delta with ||m|| > tau, 'clip' rescales it to norm
    tau.  Accepted deltas get exactly 1.0 (a bitwise no-op).  ``tau`` is a
    float or an f32 tensor broadcastable against ``nrm`` (per-world (B, 1)
    thresholds); either way it acts as an f32 value, and the clip divides
    by the norm as JAX does (a Python scalar over a tensor would multiply
    by a reciprocal)."""
    if rule == "trim":
        return (nrm <= tau).float()
    if not torch.is_tensor(tau):
        tau = torch.full_like(nrm, tau)
    return torch.clamp(tau / torch.clamp(nrm, min=1e-30), max=1.0).float()


def mix_worlds(bx: torch.Tensor, bxt: torch.Tensor, eta: torch.Tensor,
               dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World-batched mixing pass: (B, W, D) buffers, (B,) per-world eta,
    (B, W) dt.  There is no eta == 0 shortcut: a baseline world computes
    ``a + 0 * d``, exact for finite ``d`` (up to the sign of zero), as in
    the fused kernels' mixing tail."""
    eta32 = eta.float()[:, None]
    c = (0.5 * (1.0 - torch.exp(-2.0 * eta32 * dt.float()))
         ).to(bx.dtype)[:, :, None]
    d = bxt - bx
    return bx + c * d, bxt - c * d


@dataclasses.dataclass(frozen=True)
class FlatGossipEngine:
    """Fused event engine bound to a layout and A2CiD2 params.

    Comm batches launch the kernels on CUDA buffers and take the plain
    versions on CPU buffers.  ``robust_clip`` + ``robust_rule`` engage
    robust aggregation on the channel passes (None = plain m-term; tau =
    robust_clip):

      'trim'  — reject the whole delta when ||m||_2 > tau (m -> 0);
      'clip'  — rescale to m * min(1, tau / ||m||_2);
      'coord' — clip each coordinate to [-tau, +tau] inside the kernel.

    The norm rules cost one extra reduce over (x, xp) for the per-worker
    scale; the kernel itself stays 3 reads + 2 writes.
    """

    layout: FlatLayout
    params: A2CiD2Params
    robust_clip: float | None = None
    robust_rule: str = "trim"

    def __post_init__(self):
        if self.robust_rule not in ("trim", "clip", "coord"):
            raise ValueError("robust_rule must be 'trim', 'clip', or "
                             f"'coord', got {self.robust_rule!r}")

    @classmethod
    def for_pytree(cls, tree: PyTree, params: A2CiD2Params, *,
                   stacked: bool = True, worlds: bool = False,
                   robust_clip: float | None = None,
                   robust_rule: str = "trim") -> "FlatGossipEngine":
        return cls(FlatLayout.from_pytree(tree, stacked=stacked,
                                          worlds=worlds),
                   params, robust_clip, robust_rule)

    def pack(self, tree: PyTree) -> torch.Tensor:
        return self.layout.pack(tree)

    def unpack(self, buf: torch.Tensor) -> PyTree:
        return self.layout.unpack(buf)

    def pack_local(self, tree: PyTree) -> torch.Tensor:
        return self.layout.pack_local(tree)

    def unpack_local(self, vec: torch.Tensor) -> PyTree:
        return self.layout.unpack_local(vec)

    def pack_worlds(self, tree: PyTree) -> torch.Tensor:
        return self.layout.pack_worlds(tree)

    def unpack_worlds(self, buf: torch.Tensor) -> PyTree:
        return self.layout.unpack_worlds(buf)

    def mix(self, bx: torch.Tensor, bxt: torch.Tensor, dt
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Standalone mixing sweep (engine prologue and gradient ticks), plain
        PyTorch: a flat buffer is a single-leaf pytree."""
        return apply_mixing(bx, bxt, self.params.eta, dt)

    def batch(self, bx: torch.Tensor, bxt: torch.Tensor,
              partner: torch.Tensor, dt_next: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused group [p2p(partner), mix(dt_next)] on (W, D) buffers.
        ``bxt`` is consumed (the CUDA kernel updates it in place)."""
        p = self.params
        return gossip_event_stacked(bx, bxt, partner, dt_next, eta=p.eta,
                                    alpha=p.alpha, alpha_t=p.alpha_tilde)

    def batch_local(self, bx: torch.Tensor, bxt: torch.Tensor,
                    xp: torch.Tensor, dt_next
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused group on one worker's (D,) vectors (the SPMD path):
        ``xp`` the partner's current flat x (what the worker axis's permute
        delivered), ``dt_next`` one f32.  ``bxt`` is consumed."""
        p = self.params
        return p2p_mix_event(bx, bxt, xp, dt_next, eta=p.eta, alpha=p.alpha,
                             alpha_t=p.alpha_tilde)

    # ------------------------------------------- unreliable-channel passes
    def _coord_clip(self) -> float | None:
        return self.robust_clip if self.robust_rule == "coord" else None

    @staticmethod
    def delta_norms(bx: torch.Tensor, xp: torch.Tensor,
                    corrupt: torch.Tensor, axes: int | None = 1
                    ) -> torch.Tensor:
        """f32 L2 norms of the corrupted channel deltas over the row axis
        ``axes`` ((W,) for (W, D) buffers with axes=1, (B, W) for worlds
        with axes=2, one 0-dim norm for a worker's (D,) vector with
        axes=None): the subtraction at the buffer dtype, the squares and
        sum in f32."""
        cadv = (1.0 + corrupt.float()).to(bx.dtype).unsqueeze(-1)
        m32 = (bx - cadv * xp).float()
        return torch.sqrt((m32 * m32).sum(dim=axes))

    def _mscale(self, bx: torch.Tensor, xp: torch.Tensor,
                corrupt: torch.Tensor, axes: int | None = 1,
                taus: torch.Tensor | None = None) -> torch.Tensor:
        """Per-worker robust scale (ones when no norm rule is on).  The
        per-world (B,) ``taus`` replace the static ``robust_clip``; tau =
        inf accepts every finite delta."""
        if taus is None and (self.robust_clip is None
                             or self.robust_rule == "coord"):
            return torch.ones(corrupt.shape, dtype=torch.float32,
                              device=corrupt.device)
        tau = self.robust_clip if taus is None else taus[:, None]
        return norm_scale(self.delta_norms(bx, xp, corrupt, axes), tau,
                          self.robust_rule)

    def channel_batch(self, bx: torch.Tensor, bxt: torch.Tensor,
                      xp: torch.Tensor, corrupt: torch.Tensor,
                      dt_next: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused channel group on (W, D) buffers: ``xp`` the
        pre-gathered partner values, ``corrupt`` the (W,) received-value
        multiplier offsets; the engine's robust rule selects the m-term.
        ``bxt`` is consumed (the CUDA kernel updates it in place)."""
        p = self.params
        mscale = self._mscale(bx, xp, corrupt)
        return channel_event_stacked(bx, bxt, xp, corrupt, mscale, dt_next,
                                     eta=p.eta, alpha=p.alpha,
                                     alpha_t=p.alpha_tilde,
                                     clip=self._coord_clip())

    def channel_batch_scaled(self, bx: torch.Tensor, bxt: torch.Tensor,
                             xp: torch.Tensor, corrupt: torch.Tensor,
                             mscale: torch.Tensor, dt_next: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """Channel group with an EXTERNAL (W,) mscale (the self-healing
        defense's decision); also returns the kernel's (W,) rejection mask
        for the trust loop."""
        p = self.params
        return channel_event_stacked(bx, bxt, xp, corrupt, mscale, dt_next,
                                     eta=p.eta, alpha=p.alpha,
                                     alpha_t=p.alpha_tilde, clip=None,
                                     want_rej=True)

    def channel_batch_local(self, bx: torch.Tensor, bxt: torch.Tensor,
                            xp: torch.Tensor, corrupt: torch.Tensor,
                            dt_next) -> tuple[torch.Tensor, torch.Tensor]:
        """Channel group on one worker's (D,) vectors (the SPMD path):
        ``corrupt`` the 0-dim f32 offset on this worker's received value;
        the robust rule's scale comes from the norm of this one delta.
        ``bxt`` is consumed."""
        p = self.params
        mscale = self._mscale(bx, xp, corrupt, axes=None)
        return channel_event_local(bx, bxt, xp, corrupt, mscale, dt_next,
                                   eta=p.eta, alpha=p.alpha,
                                   alpha_t=p.alpha_tilde,
                                   clip=self._coord_clip())

    @staticmethod
    def partner_values(ring: torch.Tensor, bx: torch.Tensor,
                       partner: torch.Tensor, src_slot: torch.Tensor
                       ) -> torch.Tensor:
        """Per-worker partner reads: fresh rows of ``bx`` where
        ``src_slot == H``, ring slots otherwise."""
        return ring_read(ring, bx, partner, src_slot)

    # ----------------------------------------------- world-batched passes
    def mix_batch(self, bx: torch.Tensor, bxt: torch.Tensor,
                  dt: torch.Tensor, eta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """World-batched standalone mixing sweep (prologue and gradient
        ticks), plain PyTorch."""
        return mix_worlds(bx, bxt, eta, dt)

    @staticmethod
    def batch_worlds(bx: torch.Tensor, bxt: torch.Tensor,
                     partner: torch.Tensor, dt_next: torch.Tensor, pw
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One fused group [p2p, mix] on (B, W, D) buffers; ``pw`` the
        per-world (eta, alpha, alpha_t).  ``bxt`` is consumed."""
        return gossip_event_worlds(bx, bxt, partner, dt_next, *pw)

    def channel_batch_worlds(self, bx: torch.Tensor, bxt: torch.Tensor,
                             xp: torch.Tensor, corrupt: torch.Tensor,
                             dt_next: torch.Tensor, pw,
                             taus: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """World-batched channel group: pre-gathered (B, W, D) partner
        values, (B, W) corrupt offsets, per-world dynamics; the engine's
        robust rule derives the (B, W) mscale, with the (B,) ``taus``
        replacing the static threshold per world when given."""
        mscale = self._mscale(bx, xp, corrupt, axes=2, taus=taus)
        return channel_event_worlds(bx, bxt, xp, corrupt, mscale, dt_next,
                                    *pw, clip=self._coord_clip())

    @staticmethod
    def channel_batch_worlds_scaled(bx: torch.Tensor, bxt: torch.Tensor,
                                    xp: torch.Tensor, corrupt: torch.Tensor,
                                    mscale: torch.Tensor,
                                    dt_next: torch.Tensor, pw
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
        """World-batched channel group with an EXTERNAL (B, W) mscale (the
        defense's decision); also returns the kernel's (B, W) rejection
        mask."""
        return channel_event_worlds(bx, bxt, xp, corrupt, mscale, dt_next,
                                    *pw, clip=None, want_rej=True)

    @staticmethod
    def partner_values_worlds(ring: torch.Tensor | None, bx: torch.Tensor,
                              partner: torch.Tensor,
                              src_slot: torch.Tensor) -> torch.Tensor:
        """Per-world partner reads: fresh rows of ``bx`` where ``src_slot
        == H`` (or with no ring), ring slots otherwise."""
        if ring is None:
            b_idx = torch.arange(bx.shape[0], device=bx.device)[:, None]
            return bx[b_idx, partner.long()]
        return ring_read_worlds(ring, bx, partner, src_slot)
