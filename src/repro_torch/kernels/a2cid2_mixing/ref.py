"""Plain PyTorch versions of the fused A2CiD2 gossip batches.

They are the oracles the hand kernels are held against on the card, and
the path the CPU takes.  The order of operations is the JAX package's
(``repro.kernels.a2cid2_mixing.ref``), so at f32 the two agree to the
rounding of ``exp``.
"""
from __future__ import annotations

import torch


def dtype_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` and back: how JAX binds a weak Python
    scalar (the coordinate clip) to an array of that dtype."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


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


def _robust_m(x: torch.Tensor, x_partner: torch.Tensor, corrupt: torch.Tensor,
              mscale: torch.Tensor, clip: float | None) -> torch.Tensor:
    """Channel m-term: the corrupted received value, robustly aggregated.

    ``corrupt`` (W,) is the multiplier OFFSET on the received partner value
    (honest 0 => (1 + 0) * xp == xp bitwise), ``mscale`` (W,) the per-worker
    robust scale the caller derived from the delta's norm (1 = accept, also
    bitwise exact), ``clip`` the coordinate-clip rule, rounded to the
    buffer dtype.  ``torch.clamp`` propagates NaN, as ``jnp.clip`` does.
    """
    cadv = (1.0 + corrupt.float()).to(x.dtype)[:, None]
    m = (x - cadv * x_partner) * mscale.float().to(x.dtype)[:, None]
    if clip is not None:
        c = dtype_scalar(clip, x.dtype)
        m = torch.clamp(m, -c, c)
    return m


def channel_gossip_stacked_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                               x_partner: torch.Tensor, corrupt: torch.Tensor,
                               mscale: torch.Tensor, dt_next: torch.Tensor, *,
                               eta: float, alpha: float, alpha_t: float,
                               clip: float | None = None,
                               want_rej: bool = False):
    """One unreliable-channel gossip batch, p2p then mix.

    Like ``mixing_gossip_stacked_ref`` but the partner values ``x_partner``
    (W, D) arrive pre-gathered (fresh rows or ring snapshots), ``corrupt``,
    ``mscale`` and ``dt_next`` are (W,) f32, and ``clip`` is the coordinate
    clip.  ``want_rej`` adds the (W,) f32 rejection mask ``mscale == 0`` as
    a third output.  Returns fresh tensors; the inputs are left as they
    were.
    """
    m = _robust_m(x, x_partner, corrupt, mscale, clip)
    x1 = x - alpha * m
    xt1 = x_tilde - alpha_t * m
    c = (0.5 * (1.0 - torch.exp(-2.0 * eta * dt_next.float()))
         ).to(x.dtype)[:, None]
    d = xt1 - x1
    if want_rej:
        rej = (mscale.float() == 0.0).float()
        return x1 + c * d, xt1 - c * d, rej
    return x1 + c * d, xt1 - c * d
