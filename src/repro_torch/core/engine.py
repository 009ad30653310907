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

``tick`` is the tail of a clean gradient tick in one pass: the step on
both buffers by the gradient leaves where they lie, the round's metrics
row, and the trailing mixing segment (the ``tick_tail_stacked`` kernel on
CUDA buffers; on the CPU the plain ops of ``Simulator._descend``, the
row and ``mix``).

The local passes (``batch_local``, ``channel_batch_local``, with
``pack_local`` / ``unpack_local``) run one worker's (D,) vectors: the
per-worker event of the SPMD trainer (``core/gossip.py``).

The world-batched passes (``mix_batch``, ``batch_worlds``,
``channel_batch_worlds[_scaled]``, ``partner_values_worlds``) run B
worlds' (B, W, D) buffers at once with the per-world dynamics ``pw =
(eta, alpha, alpha_t)`` as (B,) f32 tensors on the buffers' device, so
baseline and A2CiD2 worlds share one launch.  The sharded replay
(``launch/mesh_replay.py``) runs them on a shard's (B, W / NS, D) rows and
adds the boundary passes ``publish_rows`` and ``pool_partner_values``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.a2cid2_mixing.ops import (channel_event_local,
                                         channel_event_stacked,
                                         channel_event_worlds,
                                         gossip_event_stacked,
                                         gossip_event_worlds, p2p_mix_event,
                                         tick_tail)
from .a2cid2 import A2CiD2Params, apply_mixing, mixing_coeff
from .flatbuf import FlatLayout, ring_read, ring_read_worlds
from .tree import PyTree

# rows a delta-norm sum takes at once (``FlatGossipEngine.delta_norms``)
NORM_GROUP = 8


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


def _delta_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` taken at f32 or wider (a's dtype promoted), then f32."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return (a.to(acc) - b.to(acc)).float()


def mix_flat(bx: torch.Tensor, bxt: torch.Tensor, eta: float, dt
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pure mixing pass on flat buffers; ``dt`` broadcasts ((W,) against
    (W, D) after the trailing-axis insert, or a scalar against (D,)).  A
    flat buffer is a single-leaf pytree, so this is exactly
    ``a2cid2.apply_mixing``."""
    return apply_mixing(bx, bxt, eta, dt)


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

    def tick(self, bx: torch.Tensor, bxt: torch.Tensor, grads: PyTree,
             gscale: torch.Tensor, gamma: float, dt_next
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """The tail of a gradient tick in one pass on (W, D) buffers: the
        step on both buffers by ``grads`` (a pytree of the layout's
        leaves, (W, *shape), read where they lie), each row scaled by its
        ``gscale`` and by ``gamma``; the round's metrics row from the
        stepped x; then the mixing sweep for ``dt_next`` (W,).  Returns
        ``(bx, bxt, consensus, mean_sq)``.  CUDA buffers take ONE
        ``tick_tail_stacked`` call, which writes both buffers in place; CPU
        buffers the plain version, the ops of ``Simulator._descend``, the
        row and ``mix``.  Both buffers are consumed."""
        eta = self.params.eta
        coeff = None if eta == 0.0 else mixing_coeff(
            eta, torch.as_tensor(dt_next, dtype=torch.float32,
                                 device=bx.device))
        return tick_tail(bx, bxt, self.layout.treedef.flatten_up_to(grads),
                         [s.offset for s in self.layout.specs], gscale,
                         coeff, gamma=gamma)

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
        ``axes``, the last one ((W,) for (W, D) buffers with axes=1, (B, W)
        for worlds with axes=2, one 0-dim norm for a worker's (D,) vector
        with axes=None): the product at the buffer dtype, the subtraction,
        the squares and the sum in f32 (or wider).  JAX writes the
        difference at the buffer dtype too, but XLA drops the rounding of a
        value that is converted straight to f32, so at bf16 the JAX norms
        are these.

        The rows are summed ``NORM_GROUP`` at a time, every sum on a
        (NORM_GROUP, D) block: PyTorch picks a reduction's split (CUDA
        blocks and lanes, CPU threads) from the number of rows as well as
        their length, so one sum over all rows is not bit for bit the same
        rows summed among fewer, and the sharded replay's (B, W / NS, D)
        banks must see the single-device norms.  The last block overlaps
        the one before it, or is filled out with rows whose sums are
        dropped.  Rows start 16-byte aligned when D is a multiple of 4, as
        a ``FlatLayout``'s padded width is."""
        cadv = (1.0 + corrupt.float()).to(bx.dtype).unsqueeze(-1)
        m32 = _delta_f32(bx, cadv * xp)
        if axes is None:
            return torch.sqrt((m32 * m32).sum())
        if axes != m32.dim() - 1:
            raise ValueError(f"delta_norms reduces the last axis, got "
                             f"axes={axes} for {m32.dim()}-d buffers")
        rows = m32.reshape(-1, m32.shape[-1])
        r, n = rows.shape[0], max(rows.shape[0], NORM_GROUP)
        sq = m32.new_empty((n, rows.shape[1]))
        torch.mul(rows, rows, out=sq[:r])
        sums = m32.new_empty(n)
        for s in range(0, n, NORM_GROUP):
            s = min(s, n - NORM_GROUP)
            torch.sum(sq[s:s + NORM_GROUP], dim=1,
                      out=sums[s:s + NORM_GROUP])
        return torch.sqrt(sums[:r]).reshape(m32.shape[:-1])

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

    # ------------------------------------------- sharded-replay passes
    @staticmethod
    def publish_rows(ring: torch.Tensor | None, bx: torch.Tensor,
                     rows: torch.Tensor, slots: torch.Tensor
                     ) -> torch.Tensor:
        """Resolve the (B, nb) boundary rows a shard publishes into their
        (B, nb, D) channel values: fresh rows of ``bx`` at the sentinel
        slot (or with no ring), local snapshot-ring reads otherwise.  The
        PUBLISHER resolves staleness against its own (B, H, Ws, D) ring, so
        the value that crosses to the reader is bit for bit the one the
        single-device ``ring_read_worlds`` gather would have produced."""
        if ring is None:
            b_idx = torch.arange(bx.shape[0], device=bx.device)[:, None]
            return bx[b_idx, rows.long()]
        return ring_read_worlds(ring, bx, rows, slots)

    @staticmethod
    def pool_partner_values(pool: torch.Tensor, hop: torch.Tensor,
                            pos: torch.Tensor, xp_local: torch.Tensor,
                            is_cross: torch.Tensor) -> torch.Tensor:
        """Merge pool reads into the shard's partner values: cross rows read
        ``pool[hop, b, pos]`` (the block published by the source shard),
        intra and idle rows keep the shard-local gather ``xp_local``."""
        b_idx = torch.arange(pool.shape[1], device=pool.device)[:, None]
        xp_cross = pool[hop.long(), b_idx, pos.long()]
        return torch.where(is_cross[:, :, None], xp_cross, xp_local)
