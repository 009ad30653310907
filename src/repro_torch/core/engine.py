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
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.a2cid2_mixing.ops import gossip_event_stacked
from .a2cid2 import A2CiD2Params, apply_mixing
from .flatbuf import FlatLayout
from .tree import PyTree


@dataclasses.dataclass(frozen=True)
class FlatGossipEngine:
    """Fused event engine bound to a layout and A2CiD2 params.

    Comm batches launch the kernel on CUDA buffers and take the plain
    version on CPU buffers.  ``robust_clip``/``robust_rule`` name the
    robust aggregation of the unreliable-channel passes: the rule is
    validated here, and a clip is refused because those passes are not
    ported yet.
    """

    layout: FlatLayout
    params: A2CiD2Params
    robust_clip: float | None = None
    robust_rule: str = "trim"

    def __post_init__(self):
        if self.robust_rule not in ("trim", "clip", "coord"):
            raise ValueError("robust_rule must be 'trim', 'clip', or "
                             f"'coord', got {self.robust_rule!r}")
        if self.robust_clip is not None:
            raise NotImplementedError(
                "robust_clip (the unreliable-channel passes) is not ported "
                "to PyTorch yet")

    @classmethod
    def for_pytree(cls, tree: PyTree, params: A2CiD2Params, *,
                   stacked: bool = True) -> "FlatGossipEngine":
        return cls(FlatLayout.from_pytree(tree, stacked=stacked), params)

    def pack(self, tree: PyTree) -> torch.Tensor:
        return self.layout.pack(tree)

    def unpack(self, buf: torch.Tensor) -> PyTree:
        return self.layout.unpack(buf)

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
