"""Attention mixers, ported from ``repro.models.attention``: GQA (RoPE,
qk-norm, sliding window) and DeepSeek-V3's multi-head latent attention
(MLA), each with the full-sequence forward used by training and prefill and
single-token decode against a cache.  A windowed layer's cache is a ring of
``window`` rows; every cache row records the absolute position it holds,
per sequence, so the slots of a continuous batch decode at their own
positions.  MLA caches the compressed latents and the shared RoPE key, and
expands K and V from the whole cache at every step, as the JAX package
does (no weight absorption).

``attention_impl == "pallas"`` routes the scores through the hand-written
flash kernel on the card (its plain version on the CPU); "xla" is the plain
einsum path, ``_sdpa``.  The sharding hints are dropped: one card has no
mesh.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels.dense_f32.ops import dense
from ..kernels.flash_attention.ops import flash_attention
from .config import MLAConfig, ModelConfig
from .layers import dense_init, init_rmsnorm, rmsnorm

NEG_INF = -1e30


# --------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0
               ) -> tuple[int, np.ndarray]:
    """(rotated dims, inverse frequencies) computed in numpy as the JAX
    package computes them, so the two are bitwise equal."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return rot, inv


@functools.lru_cache(maxsize=None)
def _inv_freqs_on(head_dim: int, theta: float, fraction: float,
                  device: torch.device) -> tuple[int, torch.Tensor]:
    """``rope_freqs`` copied to ``device`` once: a copy from pageable host
    memory waits for the card's queue to drain, which would happen twice a
    layer in every forward and decode step."""
    rot, inv = rope_freqs(head_dim, theta, fraction)
    return rot, torch.as_tensor(inv, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim) or (..., S, head_dim); positions
    (..., S).  Angles and their cos/sin in f32, the rotation in x's
    dtype."""
    rot, inv = _inv_freqs_on(x.shape[-1], theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    if x.dim() == cos.dim() + 1:                      # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    xr = x[..., :rot]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.reshape(xr.shape)
    return torch.cat([out, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------- GQA

def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype
                   ) -> dict:
    hd = cfg.resolved_head_dim
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p = {
        "wq": dense_init(generator, d, (d, h * hd), dtype),
        "wk": dense_init(generator, d, (d, kv * hd), dtype),
        "wv": dense_init(generator, d, (d, kv * hd), dtype),
        "wo": dense_init(generator, h * hd, (h * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, generator.device)
        p["k_norm"] = init_rmsnorm(hd, dtype, generator.device)
    return p


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    b, s, _ = x.shape
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = dense(x, p["wq"]).reshape(b, s, h, hd)
    k = dense(x, p["wk"]).reshape(b, s, kv, hd)
    v = dense(x, p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd), boolean mask (S,T) or (B,S,T) ->
    (B, S, H*hd).  Scores in the activation dtype, softmax in f32."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if mask.dim() == 2:
        mask = mask[None]
    if kv != h and s == 1:
        # decode: grouped-query einsum, no G-fold copy of the KV cache
        g = h // kv
        qg = q.reshape(b, 1, kv, g, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, k)
        logits = logits.float() / math.sqrt(hd)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        return out.reshape(b, 1, h * v.shape[-1])
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k)
    logits = logits.float() / math.sqrt(hd)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out.reshape(b, s, h * v.shape[-1])


def causal_mask(s: int, window: int | None = None, device=None
                ) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= j > i - window
    return m


def apply_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int | None = None
                    ) -> torch.Tensor:
    q, k, v = _qkv(p, cfg, x, positions)
    if cfg.attention_impl == "pallas":
        b, s, h, hd = q.shape
        out = flash_attention(q, k, v, causal=True, window=window)
        out = out.reshape(b, s, h * hd)
    elif cfg.attention_impl == "xla":
        out = _sdpa(q, k, v, causal_mask(x.shape[1], window, x.device), cfg)
    else:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    return dense(out, p["wo"])


# ------------------------------------------------------------- GQA decoding

def decode_positions(pos, batch: int, device=None) -> torch.Tensor:
    """(B,) int32 per-slot positions from a Python int (made on
    ``device``), a 0-d tensor or an already-(B,) tensor ``pos``."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((batch,), int(pos), dtype=torch.int32,
                          device=device)
    return torch.broadcast_to(pos.to(device=device, dtype=torch.int32),
                              (batch,))


def _cache_slots(pos_vec: torch.Tensor, size: int, window: int | None
                 ) -> torch.Tensor:
    """(B,) cache row per sequence: ``pos % size`` in a ring, else the
    position clamped to the last row once past capacity (the JAX package's
    ``dynamic_update_slice`` start clamping)."""
    return pos_vec % size if window else torch.clamp(pos_vec, max=size - 1)


def _update_slot(cache: torch.Tensor, update: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Write ``update[b]`` at row ``slot[b]`` of every sequence's cache:
    cache (B, size, ...), update (B, 1, ...), slot (B,).  Out of place (a
    select, not an indexed write), so the old cache stays intact for
    ``gate_caches`` and the function runs under ``torch.func.vmap``."""
    hit = torch.arange(cache.shape[1], device=cache.device)[None, :] \
        == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    return torch.where(hit, update.to(cache.dtype), cache)


def _slot_mask(spos: torch.Tensor, pos_vec: torch.Tensor,
               window: int | None) -> torch.Tensor:
    """(B, 1, size) visibility mask from per-sequence slot positions."""
    mask = (spos >= 0) & (spos <= pos_vec[:, None])
    if window:
        mask = mask & (spos > pos_vec[:, None] - window)
    return mask[:, None, :]


def init_attn_cache(cfg: ModelConfig, batch: int, length: int,
                    window: int | None, dtype, device=None) -> dict:
    """A dense cache of ``length`` rows, or a ring of ``min(length,
    window)`` rows for a windowed layer; ``slot_pos`` -1 marks an empty
    row."""
    size = min(length, window) if window else length
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        # absolute position held by each sequence's rows (-1 = empty)
        "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                               device=device),
    }


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor, pos,
                     cache: dict, window: int | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D), ``pos`` a scalar or (B,) per-slot positions -> (out
    (B, 1, D), new cache).  k is rotated at its absolute position before
    it is cached."""
    b = x.shape[0]
    pos_vec = decode_positions(pos, b, x.device)
    q, k, v = _qkv(p, cfg, x, pos_vec[:, None])
    slot = _cache_slots(pos_vec, cache["k"].shape[1], window)
    ck = _update_slot(cache["k"], k, slot)
    cv = _update_slot(cache["v"], v, slot)
    spos = _update_slot(cache["slot_pos"], pos_vec[:, None], slot)
    out = _sdpa(q, ck, cv, _slot_mask(spos, pos_vec, window), cfg)
    return out @ p["wo"], {"k": ck, "v": cv, "slot_pos": spos}


# ---------------------------------------------------------------------- MLA

def init_mla(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    if m.q_lora_rank is None:     # q straight from d_model (Kanana-2)
        q = {"w_q": dense_init(generator, d, (d, h * qk), dtype)}
    else:
        q = {"w_dq": dense_init(generator, d, (d, m.q_lora_rank), dtype),
             "q_norm": init_rmsnorm(m.q_lora_rank, dtype, dev),
             "w_uq": dense_init(generator, m.q_lora_rank,
                                (m.q_lora_rank, h * qk), dtype)}
    return {
        **q,
        "w_dkv": dense_init(generator, d,
                            (d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype, dev),
        "w_uk": dense_init(generator, m.kv_lora_rank,
                           (m.kv_lora_rank, h * m.qk_nope_head_dim), dtype),
        "w_uv": dense_init(generator, m.kv_lora_rank,
                           (m.kv_lora_rank, h * m.v_head_dim), dtype),
        "wo": dense_init(generator, h * m.v_head_dim,
                         (h * m.v_head_dim, d), dtype),
    }


def _mla_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """Returns q (B,S,H,qk), the latent c (B,S,rank), k_rope (B,S,rope)."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank is None:
        q = dense(x, p["w_q"])
    else:
        q = dense(rmsnorm(dense(x, p["w_dq"]), p["q_norm"], cfg.norm_eps),
                  p["w_uq"])
    q = q.reshape(b, s, cfg.num_heads, qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    dkv = dense(x, p["w_dkv"])
    c = rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return q, c, k_rope


def _mla_expand_kv(p: dict, cfg: ModelConfig, c: torch.Tensor,
                   k_rope: torch.Tensor):
    """Up-project the latents to per-head K (the RoPE key shared by every
    head) and V."""
    m: MLAConfig = cfg.mla
    b, t, _ = c.shape
    h = cfg.num_heads
    k_nope = dense(c, p["w_uk"]).reshape(b, t, h, m.qk_nope_head_dim)
    v = dense(c, p["w_uv"]).reshape(b, t, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1)
    return k, v


def apply_mla(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int | None = None
              ) -> torch.Tensor:
    """The full-sequence forward; always the plain ``_sdpa`` (the JAX
    package's MLA has no kernel path either)."""
    q, c, k_rope = _mla_qkv(p, cfg, x, positions)
    k, v = _mla_expand_kv(p, cfg, c, k_rope)
    out = _sdpa(q, k, v, causal_mask(x.shape[1], window, x.device), cfg)
    return dense(out, p["wo"])


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   window: int | None, dtype, device=None) -> dict:
    """The compressed cache: ``kv_lora_rank + qk_rope_head_dim`` values a
    token, beside ``slot_pos``."""
    m: MLAConfig = cfg.mla
    size = min(length, window) if window else length
    return {
        "c": torch.zeros((batch, size, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, size, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                               device=device),
    }


def decode_mla(p: dict, cfg: ModelConfig, x: torch.Tensor, pos,
               cache: dict, window: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D), ``pos`` a scalar or (B,) -> (out (B, 1, D), new
    cache): the latents written at each sequence's slot, then K and V
    expanded from the whole cache."""
    b = x.shape[0]
    pos_vec = decode_positions(pos, b, x.device)
    q, c, k_rope = _mla_qkv(p, cfg, x, pos_vec[:, None])
    slot = _cache_slots(pos_vec, cache["c"].shape[1], window)
    cc = _update_slot(cache["c"], c, slot)
    cr = _update_slot(cache["k_rope"], k_rope, slot)
    spos = _update_slot(cache["slot_pos"], pos_vec[:, None], slot)
    k, v = _mla_expand_kv(p, cfg, cc, cr)
    out = _sdpa(q, k, v, _slot_mask(spos, pos_vec, window), cfg)
    return out @ p["wo"], {"c": cc, "k_rope": cr, "slot_pos": spos}
