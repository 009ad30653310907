"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], ported from
``repro.models.ssm``.

Training and prefill use the chunked SSD algorithm (quadratic within chunks
of length Q, linear across chunks); decode is the O(1)-a-token state
update.  The JAX package's three- and four-operand einsums are written as
pairwise contractions, so that the order of the contractions, and the
memory of their intermediates, are fixed here and not left to the einsum
path optimiser.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig, SSMConfig
from .layers import dense_init, rmsnorm


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def init_ssd(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """``A_log`` and ``dt_bias`` come from numpy's ``RandomState(1)`` and
    ``RandomState(0)`` as in the JAX package, so they equal its values; the
    projections and the conv come from the generator."""
    s, d_inner, h = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    dev = generator.device
    # dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1]
    dt = np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(1e-1), size=h)).astype(np.float32)
    dt_bias = dt + np.log(-np.expm1(-dt))
    a_log = np.log(np.random.RandomState(1).uniform(1, 16, size=h))
    return {
        "in_proj": dense_init(generator, cfg.d_model,
                              (cfg.d_model,
                               2 * d_inner + 2 * s.n_groups * s.d_state + h),
                              dtype),
        "conv_w": dense_init(generator, s.conv_width,
                             (s.conv_width, conv_dim), dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.as_tensor(a_log, device=dev).to(dtype),
        "dt_bias": torch.as_tensor(dt_bias, device=dev).to(dtype),
        "D": torch.ones((h,), dtype=dtype, device=dev),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, d_inner, (d_inner, cfg.d_model),
                               dtype),
    }


def _split_proj(p: dict, cfg: ModelConfig, x: torch.Tensor):
    s, d_inner, h = _dims(cfg)
    gn = s.n_groups * s.d_state
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :d_inner],
            zxbcdt[..., d_inner:2 * d_inner + 2 * gn],
            zxbcdt[..., -h:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d, then SiLU: xbc (B,S,C), w (W,C), state
    (B,W-1,C) for decode.  Returns (out, new_state)."""
    width = w.shape[0]
    pad = (xbc.new_zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:])
           if state is None else state)
    full = torch.cat([pad, xbc], dim=1)                   # (B, S+W-1, C)
    s = xbc.shape[1]
    out = sum(full[:, k:k + s] * w[k] for k in range(width)) + b
    return F.silu(out), full[:, -(width - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q): entry (i, j) is a_{j+1} + .. + a_i on and
    below the diagonal, -inf above it."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b_: torch.Tensor,
                c_: torch.Tensor, chunk: int):
    """The SSD scan. x (B,S,H,P), a (B,S,H) = dt * A (< 0), B_ / C_
    (B,S,H,N).  Returns y (B,S,H,P) and the final state (B,H,P,N)."""
    bb, s, h, p = x.shape
    n = b_.shape[-1]
    nc = s // chunk
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"

    def r(t):
        return t.reshape(bb, nc, chunk, *t.shape[2:])

    x, a, b_, c_ = r(x), r(a), r(b_), r(c_)
    a = a.float()
    a_cum = torch.cumsum(a, dim=2)                        # (B,nc,Q,H)
    # 1) the diagonal (within-chunk) term, quadratic in Q:
    #    (C_l . B_s) * L[l, s], then against x_s
    decay = torch.exp(_segsum(a.movedim(-1, -2)))         # (B,nc,H,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bchls", c_, b_)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * decay.to(c_.dtype),
                          x)
    # 2) each chunk's input state
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          b_ * decay_states.to(b_.dtype)[..., None], x)
    # 3) the recurrence across chunks
    chunk_decay = torch.exp(a_cum[:, :, -1, :])           # (B,nc,H)
    hs = [x.new_zeros((bb, h, p, n))]                     # states entering
    for i in range(nc):
        hs.append(hs[-1] * chunk_decay[:, i, :, None, None].to(x.dtype)
                  + states[:, i])
    h_prev = torch.stack(hs[:-1], dim=1)                  # (B,nc,H,P,N)
    # 4) the off-diagonal (cross-chunk) output
    out_decay = torch.exp(a_cum)                          # (B,nc,Q,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         c_ * out_decay.to(c_.dtype)[..., None], h_prev)
    return (y_diag + y_off).reshape(bb, s, h, p), hs[-1]


def apply_ssd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions=None
              ) -> torch.Tensor:
    s, d_inner, h = _dims(cfg)
    b, seq, _ = x.shape
    gn = s.n_groups * s.d_state
    z, xbc, dt = _split_proj(p, cfg, x)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner].reshape(b, seq, h, s.head_dim)
    b_ = xbc[..., d_inner:d_inner + gn].reshape(b, seq, s.n_groups,
                                                 s.d_state)
    c_ = xbc[..., d_inner + gn:].reshape(b, seq, s.n_groups, s.d_state)
    b_ = b_.repeat_interleave(h // s.n_groups, dim=2)
    c_ = c_.repeat_interleave(h // s.n_groups, dim=2)
    dt = F.softplus(dt.float() + p["dt_bias"].float())   # (B,S,H)
    a = -torch.exp(p["A_log"].float())
    y, _ = ssd_chunked(xs * dt[..., None].to(xs.dtype), dt * a, b_, c_,
                       s.chunk)
    y = y + p["D"].to(y.dtype)[:, None] * xs
    y = y.reshape(b, seq, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


# ------------------------------------------------------------------- decode

def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device=None
                   ) -> dict:
    """The recurrent state and the conv's last W - 1 inputs: the same size
    at every context length."""
    s, d_inner, h = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        "h": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=dtype,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def decode_ssd(p: dict, cfg: ModelConfig, x: torch.Tensor, pos, cache: dict
               ) -> tuple[torch.Tensor, dict]:
    """x (B,1,D): the O(1) state update."""
    s, d_inner, h = _dims(cfg)
    b = x.shape[0]
    gn = s.n_groups * s.d_state
    z, xbc, dt = _split_proj(p, cfg, x)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    xs = xbc[..., :d_inner].reshape(b, h, s.head_dim)
    b_ = xbc[..., d_inner:d_inner + gn].reshape(b, s.n_groups, s.d_state)
    c_ = xbc[..., d_inner + gn:].reshape(b, s.n_groups, s.d_state)
    b_ = b_.repeat_interleave(h // s.n_groups, dim=1)    # (B,H,N)
    c_ = c_.repeat_interleave(h // s.n_groups, dim=1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * a)[..., None, None].to(cache["h"].dtype)
    update = torch.einsum("bhp,bhn->bhpn", xs * dt[..., None].to(xs.dtype),
                          b_)
    hs = cache["h"] * decay + update
    y = torch.einsum("bhpn,bhn->bhp", hs, c_)
    y = y + p["D"].to(y.dtype)[:, None] * xs
    y = rmsnorm(y.reshape(b, 1, d_inner) * F.silu(z), p["norm"],
                cfg.norm_eps)
    return y @ p["out_proj"], {"h": hs, "conv": conv_state}
