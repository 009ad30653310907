"""A Qwen3-style dense decoder, plain PyTorch, float32.

Per layer: RMSNorm, GQA attention (q, k, v projections without bias,
RMSNorm of every q and k head, RoPE at ``rope_theta``, a causal softmax
over scores scaled by 1/sqrt(head_dim)), the output projection, a residual;
RMSNorm, a SwiGLU MLP, a residual.  Then a final RMSNorm and the tied
embedding as the output head.  The loss is the mean cross-entropy over the
padded vocabulary, in float32.

Departures from the published model, each the port's: RMSNorm scales are
stored as their deviation from 1 (``x * inv * (1 + s)``); RoPE rotates
interleaved pairs (dims 2i, 2i + 1), where Hugging Face's Qwen3 rotates
the two halves of a head, the same map under a fixed permutation of the
q and k columns; the vocabulary is padded to a multiple of 256.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _rms(x: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + s)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd): the pair (2i, 2i + 1) turned by the angle
    pos * theta^(-2i / hd)."""
    hd, s = x.shape[-1], x.shape[1]
    inv = torch.as_tensor(1.0 / theta ** (np.arange(0, hd, 2,
                                                    dtype=np.float32) / hd),
                          device=x.device)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).reshape(x.shape)


def loss(p: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of one worker's (B, S) tokens."""
    eps = cfg["rms_norm_eps"]
    h_n, kv_n = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    tokens = batch["inputs"]
    b, s = tokens.shape
    emb = p["embed"]["tok"]
    x = emb[tokens]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    layers = p["groups"][0]["b0"]
    for i in range(cfg["num_hidden_layers"]):
        w = {k: v[i] for k, v in layers["mixer"].items()}
        h = _rms(x, layers["norm1"][i], eps)
        q = _rms((h @ w["wq"]).view(b, s, h_n, hd), w["q_norm"], eps)
        k = _rms((h @ w["wk"]).view(b, s, kv_n, hd), w["k_norm"], eps)
        v = (h @ w["wv"]).view(b, s, kv_n, hd)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        k = k.repeat_interleave(h_n // kv_n, dim=2)
        v = v.repeat_interleave(h_n // kv_n, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        att = torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)
        x = x + att.reshape(b, s, h_n * hd) @ w["wo"]
        m = {k: v[i] for k, v in layers["mlp"].items()}
        h = _rms(x, layers["norm2"][i], eps)
        x = x + (torch.nn.functional.silu(h @ m["w_gate"]) * (h @ m["w_up"])) \
            @ m["w_down"]
    logits = _rms(x, p["final_norm"], eps) @ emb.T
    return torch.nn.functional.cross_entropy(
        logits.reshape(b * s, -1), batch["labels"].reshape(b * s))
