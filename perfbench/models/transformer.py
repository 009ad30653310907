"""A dense decoder of GQA attention (RoPE, qk-norm) and SwiGLU blocks with
tied embeddings, in the tree layout of the port's ``Model.init``: every
layer's leaves stacked on a leading layer axis under ``groups/0/b0``,
RMSNorm scales stored as their deviation from 1, the embedding at the
vocabulary padded to a multiple of 256 (the port's ``padded_vocab``)."""
from __future__ import annotations

import math

import torch

from ..streams import WEIGHTS, derive

WORK_UNIT = "tokens"


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab_size"] + 255) // 256 * 256


def _matrices(cfg: dict) -> dict[str, tuple]:
    """The stacked per-layer matrices: name -> (L, fan_in, fan_out)."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hd, h, kv = cfg["head_dim"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    ff = cfg["intermediate_size"]
    return {"mixer/wq": (L, d, h * hd), "mixer/wk": (L, d, kv * hd),
            "mixer/wv": (L, d, kv * hd), "mixer/wo": (L, h * hd, d),
            "mlp/w_gate": (L, d, ff), "mlp/w_up": (L, d, ff),
            "mlp/w_down": (L, ff, d)}


def matmul_params(cfg: dict) -> int:
    """Parameters that take part in a product: every layer's matrices and
    the tied embedding once, as the output head."""
    return sum(math.prod(s) for s in _matrices(cfg).values()) \
        + padded_vocab(cfg) * cfg["hidden_size"]


def init_params(cfg: dict, seed: int, device) -> dict:
    """Matrices N(0, 1/fan_in), the embedding N(0, 0.02^2), norms at 1
    (stored 0): one normal draw for every weight, carved into the
    leaves."""
    L, d, hd = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["head_dim"]
    mats = _matrices(cfg)
    vp = padded_vocab(cfg)
    total = sum(math.prod(s) for s in mats.values()) + vp * d
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    made, off = {}, 0
    for name, shape in mats.items():
        made[name] = flat[off:off + math.prod(shape)].view(shape) \
            .mul_(1.0 / math.sqrt(shape[1]))
        off += math.prod(shape)
    embed = flat[off:].view(vp, d).mul_(0.02)
    zeros = torch.zeros(L * (2 * d + 2 * hd) + d, device=device)
    mixer = {k.split("/")[1]: v for k, v in made.items()
             if k.startswith("mixer/")}
    mixer["q_norm"] = zeros[:L * hd].view(L, hd)
    mixer["k_norm"] = zeros[L * hd:2 * L * hd].view(L, hd)
    rest = zeros[2 * L * hd:]
    block = {"norm1": rest[:L * d].view(L, d), "mixer": mixer,
             "norm2": rest[L * d:2 * L * d].view(L, d),
             "mlp": {k.split("/")[1]: v for k, v in made.items()
                     if k.startswith("mlp/")}}
    return {"embed": {"tok": embed}, "final_norm": rest[2 * L * d:],
            "head": {}, "groups": [{"b0": block}]}


def work_per_round(cfg: dict, traffic: dict) -> int:
    return traffic["workers"] * traffic["batch"] * traffic["seq"]


def flops_per_round(cfg: dict, traffic: dict) -> float:
    """6 N a token for the products of weights, plus causal attention:
    QK^T and PV, 4 S^2 hd FLOPs a head and layer forward, half of them
    under the causal mask, 3x for forward and backward."""
    s = traffic["seq"]
    seqs = traffic["workers"] * traffic["batch"]
    attn = 6.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * cfg["head_dim"] * s * s
    return seqs * (6.0 * matmul_params(cfg) * s + attn)


def program_grad_fn(cfg: dict, stream):
    from repro_torch.models.config import Block, ModelConfig, uniform_blocks
    from repro_torch.models.transformer import Model, lm_grad_fn
    model = Model(ModelConfig(
        name=cfg["name"], family="dense", d_model=cfg["hidden_size"],
        vocab_size=cfg["vocab_size"],
        blocks=uniform_blocks(Block("attn", "dense"),
                              cfg["num_hidden_layers"]),
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        qk_norm=cfg["qk_norm"], rope_theta=float(cfg["rope_theta"]),
        d_ff=cfg["intermediate_size"], mlp_act=cfg["hidden_act"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"]))
    return lm_grad_fn(model, stream)
