"""Plain PyTorch versions of the fused A2CiD2 gossip batches.

They are the oracles the hand kernels are held against on the card, and
the path the CPU takes.  The order of operations is the JAX package's
(``repro.kernels.a2cid2_mixing.ref``), so at f32 the two agree to the
rounding of ``exp``, and at bf16 bit for bit.

Every Python scalar that multiplies a buffer (alpha, alpha~, the clip) is
first rounded to the buffer's dtype (``dtype_scalar``): JAX binds a weak
Python scalar that way, where PyTorch would multiply a bf16 tensor by the
f32 value and round once.  At f32 the two bindings are the same.
"""
from __future__ import annotations

import torch


def dtype_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` and back: how JAX binds a weak Python
    scalar (alpha, alpha~, gamma, the coordinate clip) to an array of that
    dtype."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def _per_world(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) per-world scalars at the buffer dtype, broadcastable against
    the (B, W, D) buffers (the JAX worlds oracles cast them the same way)."""
    v = v.to(x.dtype)
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def _coeff_worlds(eta: torch.Tensor, dt_next: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Per-(world, worker) mixing coefficient: eta in the f32 pipeline with
    no eta == 0 shortcut, (B, W, 1) at the buffer dtype."""
    eta32 = eta.float()[:, None]
    return (0.5 * (1.0 - torch.exp(-2.0 * eta32 * dt_next.float()))
            ).to(dtype)[:, :, None]


def _coeff(eta: float, dt, dtype: torch.dtype) -> torch.Tensor:
    """The mixing coefficient 0.5 * (1 - exp(-2 eta dt)) in f32 for a
    scalar ``dt`` (a float or a 0-dim / (1,) tensor), cast to ``dtype``."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    return (0.5 * (1.0 - torch.exp(-2.0 * eta * dt))).to(dtype).reshape(())


def mixing_p2p_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                   x_partner: torch.Tensor, dt, *, eta: float, alpha: float,
                   alpha_t: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One event, mix then p2p, on tensors of any shape: x, x~ mixed for
    ``dt`` (a scalar), then the p2p step against the partner's x
    (``x_partner``, already mixed).  Returns fresh tensors."""
    c = _coeff(eta, dt, x.dtype)
    d = x_tilde - x
    xm = x + c * d
    xtm = x_tilde - c * d
    m = xm - x_partner
    return (xm - dtype_scalar(alpha, x.dtype) * m,
            xtm - dtype_scalar(alpha_t, x.dtype) * m)


def p2p_mixing_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                   x_partner: torch.Tensor, dt_next, *, eta: float,
                   alpha: float, alpha_t: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One event, p2p then mix for ``dt_next`` (a scalar), on one worker's
    flat (D,) vectors (the event-engine group order).  Returns fresh
    tensors."""
    m = x - x_partner
    x1 = x - dtype_scalar(alpha, x.dtype) * m
    xt1 = x_tilde - dtype_scalar(alpha_t, x.dtype) * m
    c = _coeff(eta, dt_next, x.dtype)
    d = xt1 - x1
    return x1 + c * d, xt1 - c * d


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
    x1 = x - dtype_scalar(alpha, x.dtype) * m
    xt1 = x_tilde - dtype_scalar(alpha_t, x.dtype) * m
    c = (0.5 * (1.0 - torch.exp(-2.0 * eta * dt_next.float()))
         ).to(x.dtype)[:, None]
    d = xt1 - x1
    return x1 + c * d, xt1 - c * d


def mixing_gossip_worlds_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                             partner: torch.Tensor, dt_next: torch.Tensor,
                             eta: torch.Tensor, alpha: torch.Tensor,
                             alpha_t: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One coalesced gossip batch over B worlds at once: x, x~ are
    (B, W, D), partner and dt_next (B, W) (partners local to each world),
    eta, alpha, alpha_t (B,) f32 per-world dynamics.

    Per world this is ``mixing_gossip_stacked_ref`` with that world's
    scalars: alpha and alpha~ cast to the buffer dtype, eta through the
    f32 coefficient pipeline (``-2 * eta`` rounds like the serial
    ``-2.0 * eta``), and no eta == 0 shortcut.  Returns fresh tensors.
    """
    idx = partner.long()[:, :, None].expand(-1, -1, x.shape[2])
    m = x - torch.gather(x, 1, idx)
    x1 = x - _per_world(alpha, x) * m
    xt1 = x_tilde - _per_world(alpha_t, x) * m
    c = _coeff_worlds(eta, dt_next, x.dtype)
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
    The per-row vectors may carry a leading world axis ((B, W) against
    (B, W, D) buffers).
    """
    cadv = (1.0 + corrupt.float()).to(x.dtype).unsqueeze(-1)
    m = (x - cadv * x_partner) * mscale.float().to(x.dtype).unsqueeze(-1)
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
    x1 = x - dtype_scalar(alpha, x.dtype) * m
    xt1 = x_tilde - dtype_scalar(alpha_t, x.dtype) * m
    c = (0.5 * (1.0 - torch.exp(-2.0 * eta * dt_next.float()))
         ).to(x.dtype)[:, None]
    d = xt1 - x1
    if want_rej:
        rej = (mscale.float() == 0.0).float()
        return x1 + c * d, xt1 - c * d, rej
    return x1 + c * d, xt1 - c * d


def channel_gossip_worlds_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                              x_partner: torch.Tensor, corrupt: torch.Tensor,
                              mscale: torch.Tensor, dt_next: torch.Tensor,
                              eta: torch.Tensor, alpha: torch.Tensor,
                              alpha_t: torch.Tensor, *,
                              clip: float | None = None,
                              want_rej: bool = False):
    """One unreliable-channel gossip batch over B worlds at once: (B, W, D)
    buffers with the partner values pre-gathered per world, (B, W) f32
    ``corrupt``/``mscale``/``dt_next``, (B,) f32 per-world eta, alpha,
    alpha_t, and the coordinate ``clip`` shared by all worlds.
    ``want_rej`` adds the (B, W) f32 rejection mask ``mscale == 0``.  Per
    world this is ``channel_gossip_stacked_ref`` with that world's scalars
    (the rounding of ``mixing_gossip_worlds_ref``).  Returns fresh tensors.
    """
    m = _robust_m(x, x_partner, corrupt, mscale, clip)
    x1 = x - _per_world(alpha, x) * m
    xt1 = x_tilde - _per_world(alpha_t, x) * m
    c = _coeff_worlds(eta, dt_next, x.dtype)
    d = xt1 - x1
    if want_rej:
        rej = (mscale.float() == 0.0).float()
        return x1 + c * d, xt1 - c * d, rej
    return x1 + c * d, xt1 - c * d


def channel_p2p_mixing_ref(x: torch.Tensor, x_tilde: torch.Tensor,
                           x_partner: torch.Tensor, corrupt, mscale,
                           dt_next, *, eta: float, alpha: float,
                           alpha_t: float, clip: float | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-worker (D,) channel variant of ``p2p_mixing_ref`` (the SPMD
    path): 0-dim f32 ``corrupt`` offset, ``mscale`` and ``dt_next``.
    Returns fresh tensors."""
    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).reshape(())

    m = _robust_m(x, x_partner, scalar(corrupt), scalar(mscale), clip)
    x1 = x - dtype_scalar(alpha, x.dtype) * m
    xt1 = x_tilde - dtype_scalar(alpha_t, x.dtype) * m
    c = _coeff(eta, dt_next, x.dtype)
    d = xt1 - x1
    return x1 + c * d, xt1 - c * d


def tick_tail_stacked_ref(x: torch.Tensor, x_tilde: torch.Tensor, leaves,
                          offsets, gscale: torch.Tensor,
                          coeff: torch.Tensor | None, *, gamma: float):
    """The tail of a gradient tick on (W, D) buffers, as the replay's eager
    ops compute it: the gradient leaves (W, *shape) packed at their buffer
    columns ``offsets`` (``FlatLayout.pack``: cast to the buffer dtype,
    zeros elsewhere), each row scaled by its ``gscale`` (W,) and by
    ``gamma`` and taken off both buffers (``Simulator._descend``); the
    metrics row of the descended x (its consensus distance and the squared
    norm of its worker mean); then the mixing sweep with the (W,) f32
    coefficient ``coeff`` (``a2cid2.apply_mixing``), none for eta == 0.
    Returns fresh ``(x, x_tilde, consensus, mean_sq)``, the last two 0-dim
    f32; the inputs are left as they were."""
    w = x.shape[0]
    g = torch.zeros_like(x)
    for leaf, off in zip(leaves, offsets):
        n = leaf.numel() // w
        g[:, off:off + n] = leaf.reshape(w, n)
    g = gscale[:, None].to(g.dtype) * g
    gm = dtype_scalar(gamma, g.dtype)
    x, x_tilde = x - gm * g, x_tilde - gm * g
    mean = x.mean(dim=0, keepdim=True)
    consensus = (((x - mean) ** 2).sum() / w).float()
    mean_sq = (mean ** 2).sum().float()
    if coeff is not None:
        c = coeff.to(x.dtype)[:, None]
        d = x_tilde - x
        x, x_tilde = x + c * d, x_tilde - c * d
    return x, x_tilde, consensus, mean_sq
