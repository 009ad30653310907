"""Plain PyTorch version of the fused A2CiD2 gossip batch.

It is the oracle the hand kernel is held against on the card, and the path
the CPU takes.  The order of operations is the JAX package's
(``repro.kernels.a2cid2_mixing.ref.mixing_gossip_stacked_ref``), so the two
agree to the rounding of ``exp``.
"""
from __future__ import annotations

import torch


def mixing_gossip_stacked_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                              partner: torch.Tensor, dt_next: torch.Tensor,
                              *, eta: float, alpha: float, alpha_t: float
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One coalesced gossip batch, p2p then mix: x, x~ are (W, D), partner
    (W,) an involution (partner[w] == w for idle workers), dt_next (W,).

    Returns fresh tensors; the inputs are left as they were.
    """
    xp = x.index_select(0, partner.long())
    m = x - xp
    x1 = x - alpha * m
    xt1 = x_tilde - alpha_t * m
    c = (0.5 * (1.0 - torch.exp(-2.0 * eta * dt_next.float()))
         ).to(x.dtype)[:, None]
    d = xt1 - x1
    return x1 + c * d, xt1 - c * d
