"""Common layers: norms, MLPs, embeddings, ported from
``repro.models.layers`` (MoE is not ported yet).

Parameters are plain dicts of tensors with the JAX package's keys, shapes
and dtypes; initialisers draw from a ``torch.Generator`` on its device, so
their values differ from ``jax.random``'s (carry JAX weights with
``convert``).  The sharding hints of the JAX package are dropped: one card
has no mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig


def dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


# ------------------------------------------------------------------- inits

def dense_init(generator: torch.Generator, fan_in: int, shape, dtype
               ) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by 1 / sqrt(fan_in), drawn in
    f32 and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * 0.02).to(dtype)


# -------------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with the JAX layer's rounding: the sum of squares in f32,
    ``inv`` rounded to x's dtype, then ``(x * inv) * (1 + scale)`` in x's
    dtype.  Autograd differentiates it; the JAX package's custom VJP is the
    same function written out to keep its cotangents in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(dt)
    return (x * inv) * (1.0 + scale.to(dt))


def init_rmsnorm(dim: int, dtype, device=None) -> torch.Tensor:
    # stored as deviation from 1 (gemma-style) for clean wd behaviour
    return torch.zeros((dim,), dtype=dtype, device=device)


# --------------------------------------------------------------------- MLPs

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             act: str = "silu") -> dict:
    p = {
        "w_up": dense_init(generator, d_model, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, d_ff, (d_ff, d_model), dtype),
    }
    if act == "silu":  # gated (swiglu)
        p["w_gate"] = dense_init(generator, d_model, (d_model, d_ff), dtype)
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p["w_down"]


# --------------------------------------------------------------- embeddings

def init_embedding(generator: torch.Generator, cfg: ModelConfig, dtype
                   ) -> dict:
    if cfg.input_mode == "tokens":
        return {"tok": embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                  dtype)}
    # stubbed frontend provides embeddings; learn an input projection
    return {"in_proj": dense_init(generator, cfg.d_model,
                                  (cfg.d_model, cfg.d_model), dtype)}


def embed_inputs(p: dict, cfg: ModelConfig, inputs: torch.Tensor
                 ) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = p["tok"][inputs]
    else:
        x = inputs.to(dtype_of(cfg.param_dtype)) @ p["in_proj"]
    return x.to(dtype_of(cfg.compute_dtype))


def init_lm_head(generator: torch.Generator, cfg: ModelConfig, dtype
                 ) -> dict:
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return {}
    out = cfg.padded_vocab * cfg.num_codebooks
    return {"w": dense_init(generator, cfg.d_model, (cfg.d_model, out),
                            dtype)}


def apply_lm_head(head_p: dict, embed_p: dict, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> logits (..., num_codebooks*vocab) [codebooks folded]."""
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return x @ embed_p["tok"].T.to(x.dtype)
    return x @ head_p["w"]
