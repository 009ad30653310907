"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427],
ported from ``repro.models.rglru``.

The Griffin recurrent block: two parallel linear branches; one goes through
a causal conv1d (no activation) and the Real-Gated LRU, the other is a GeLU
gate; they are merged by an elementwise product and projected out.

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate, f32)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence is a log-depth (Hillis-Steele) scan of the linear
recurrence, with the combine of the JAX package's associative scan;
decode is the O(1) state update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, RGLRUConfig
from .layers import dense_init


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.d_rnn or cfg.d_model


def init_rglru(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    r: RGLRUConfig = cfg.rglru
    d, w = cfg.d_model, _width(cfg)
    dev = generator.device
    return {
        "w_in_rnn": dense_init(generator, d, (d, w), dtype),
        "w_in_gate": dense_init(generator, d, (d, w), dtype),
        "conv_w": dense_init(generator, r.conv_width, (r.conv_width, w),
                             dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_a": dense_init(generator, w, (w, w), dtype),
        "b_a": torch.zeros((w,), dtype=dtype, device=dev),
        "w_x": dense_init(generator, w, (w, w), dtype),
        "b_x": torch.zeros((w,), dtype=dtype, device=dev),
        # Lambda init so a ~ U[0.9, 0.999]^(1/c) at r=1 (paper's init range)
        "lam": torch.full((w,), 0.65, dtype=dtype, device=dev),
        "w_out": dense_init(generator, w, (w, d), dtype),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state: torch.Tensor | None = None):
    """Depthwise causal conv1d (no activation): x (B,S,W), w (K,W), state
    (B,K-1,W) for decode.  Returns (out, new_state)."""
    width = w.shape[0]
    pad = (x.new_zeros(x.shape[:1] + (width - 1,) + x.shape[2:])
           if state is None else state)
    full = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(full[:, k:k + s] * w[k] for k in range(width)) + b
    return out, full[:, -(width - 1):]


def _gates(p: dict, cfg: ModelConfig, u: torch.Tensor):
    """u: the conv'd rnn-branch activations (B,S,W).  Returns (log_a f32,
    beta * gated input in u's dtype)."""
    c = cfg.rglru.c
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"]).float()
    i = torch.sigmoid(u @ p["w_x"] + p["b_x"])
    log_a = -c * F.softplus(p["lam"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    return log_a, beta.to(u.dtype) * (i * u)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, in ceil(log2
    S) out-of-place steps: at offset d every position combines with the
    prefix ending d before it, (a_l, b_l) then (a_r, b_r) giving (a_l a_r,
    a_r b_l + b_r), the identity (1, 0) before the start."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_l = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_l = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = a_l * a, a * b_l + b
        d *= 2
    return b


def apply_rglru(p: dict, cfg: ModelConfig, x: torch.Tensor, positions=None
                ) -> torch.Tensor:
    u = x @ p["w_in_rnn"]
    gate = F.gelu(x @ p["w_in_gate"], approximate="tanh")
    u, _ = _conv(u, p["conv_w"], p["conv_b"])
    log_a, b = _gates(p, cfg, u)
    h = linear_scan(torch.exp(log_a).to(u.dtype), b)
    return (h * gate) @ p["w_out"]


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device=None
                     ) -> dict:
    r, w = cfg.rglru, _width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, r.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def decode_rglru(p: dict, cfg: ModelConfig, x: torch.Tensor, pos,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """x (B,1,D): the O(1) state update."""
    u = x @ p["w_in_rnn"]
    gate = F.gelu(x @ p["w_in_gate"], approximate="tanh")
    u, conv_state = _conv(u, p["conv_w"], p["conv_b"], state=cache["conv"])
    log_a, b = _gates(p, cfg, u)
    a = torch.exp(log_a).to(u.dtype)
    h = a[:, 0] * cache["h"] + b[:, 0]
    return (h[:, None] * gate) @ p["w_out"], {"h": h, "conv": conv_state}
