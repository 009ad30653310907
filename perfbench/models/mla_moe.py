"""A DeepSeek-V3-style decoder (``model_type`` ``deepseek_v3``): multi-head
latent attention without q-LoRA, ``first_k_dense_replace`` dense SwiGLU
layers, then MoE layers of sigmoid-routed experts beside shared ones, an
untied head.  This chip holds ``n_routed_experts`` of the router's
``router_experts`` in every MoE layer (from ``held_first``) and computes
their part of the layer's output for every pick, with no capacity
(``kernels.moe_experts`` on the card).

The tree is the port's ``Model.init``'s: the dense layers under
``groups/0/b0``, the MoE layers under ``groups/1/b0``, each leaf stacked on
a leading layer axis; RMSNorm scales stored as their deviation from 1;
embedding and head at the vocabulary padded to a multiple of 256.
"""
from __future__ import annotations

import math

import torch

from ..streams import WEIGHTS, derive

WORK_UNIT = "tokens"


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab_size"] + 255) // 256 * 256


def _depths(cfg: dict) -> tuple[int, int]:
    dense = cfg["first_k_dense_replace"]
    return dense, cfg["num_hidden_layers"] - dense


def _mla(cfg: dict, n: int) -> dict[str, tuple]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope, rope, v = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    return {"w_q": (n, d, h * (nope + rope)), "w_dkv": (n, d, r + rope),
            "w_uk": (n, r, h * nope), "w_uv": (n, r, h * v),
            "wo": (n, h * v, d)}


def _swiglu(d: int, f: int, lead: tuple) -> dict[str, tuple]:
    return {"w_gate": (*lead, d, f), "w_up": (*lead, d, f),
            "w_down": (*lead, f, d)}


def _matrices(cfg: dict) -> dict[str, tuple]:
    """Every matrix, by path: name -> shape (fan-in second to last)."""
    d = cfg["hidden_size"]
    dense, moe = _depths(cfg)
    held, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out = {f"0/mixer/{k}": s for k, s in _mla(cfg, dense).items()}
    out.update({f"0/mlp/{k}": s for k, s in
                _swiglu(d, cfg["intermediate_size"], (dense,)).items()})
    out.update({f"1/mixer/{k}": s for k, s in _mla(cfg, moe).items()})
    out["1/mlp/router"] = (moe, d, cfg["router_experts"])
    out.update({f"1/mlp/moe_{k[2:]}": s for k, s in
                _swiglu(d, f, (moe, held)).items()})
    out.update({f"1/mlp/shared/{k}": s for k, s in _swiglu(
        d, f * cfg["n_shared_experts"], (moe,)).items()})
    out["head"] = (d, padded_vocab(cfg))
    return out


def init_params(cfg: dict, seed: int, device) -> dict:
    """Matrices N(0, 1/fan_in), the embedding N(0, 0.02^2), the router's
    selection bias N(0, 0.01^2), norms at 1 (stored 0): one normal draw for
    every drawn weight, carved into the leaves."""
    d, r = cfg["hidden_size"], cfg["kv_lora_rank"]
    dense, moe = _depths(cfg)
    mats = _matrices(cfg)
    vp, e = padded_vocab(cfg), cfg["router_experts"]
    total = sum(math.prod(s) for s in mats.values()) + vp * d + moe * e
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    made, off = {}, 0
    for name, shape in mats.items():
        made[name] = flat[off:off + math.prod(shape)].view(shape) \
            .mul_(1.0 / math.sqrt(shape[-2]))
        off += math.prod(shape)
    embed = flat[off:off + vp * d].view(vp, d).mul_(0.02)
    bias = flat[off + vp * d:].view(moe, e).mul_(0.01)
    zeros = torch.zeros((dense + moe) * (2 * d + r) + d, device=device)

    def norms(n: int, at: int) -> tuple[dict, int]:
        take = [zeros[at:at + n * d], zeros[at + n * d:at + 2 * n * d],
                zeros[at + 2 * n * d:at + n * (2 * d + r)]]
        return ({"norm1": take[0].view(n, d), "norm2": take[1].view(n, d),
                 "kv_norm": take[2].view(n, r)}, at + n * (2 * d + r))

    def group(i: int, n: int, at: int) -> tuple[dict, int]:
        nm, at = norms(n, at)
        mixer = {k.split("/")[2]: v for k, v in made.items()
                 if k.startswith(f"{i}/mixer/")}
        mixer["kv_norm"] = nm["kv_norm"]
        mlp: dict = {}
        for k, v in made.items():
            parts = k.split("/")
            if parts[0] == str(i) and parts[1] == "mlp":
                node = mlp
                for p in parts[2:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return ({"b0": {"norm1": nm["norm1"], "mixer": mixer,
                        "norm2": nm["norm2"], "mlp": mlp}}, at)

    g0, at = group(0, dense, 0)
    g1, at = group(1, moe, at)
    g1["b0"]["mlp"]["router_bias"] = bias
    return {"embed": {"tok": embed}, "final_norm": zeros[at:],
            "head": {"w": made["head"]}, "groups": [g0, g1]}


def work_per_round(cfg: dict, traffic: dict) -> int:
    return traffic["workers"] * traffic["batch"] * traffic["seq"]


def matmul_params_per_token(cfg: dict) -> float:
    """Weights a token's products read: every matrix but the routed
    experts, plus the routed experts at their expected share, top-k x
    held / router_experts of a token's picks (6 x 8 / 128 here, the
    selection being as likely to fall on any expert)."""
    held, e = cfg["n_routed_experts"], cfg["router_experts"]
    total = 0.0
    for name, shape in _matrices(cfg).items():
        size = math.prod(shape)
        if "/moe_" in name:
            size *= cfg["num_experts_per_tok"] / e   # of the held n
        total += size
    return total


def flops_per_round(cfg: dict, traffic: dict) -> float:
    """6 N a token for the products of weights (the routed experts counted
    at W B S 6 x 8/128 picks a layer, ``matmul_params_per_token``), plus
    causal attention: QK^T over the qk head (nope + rope) and PV over the v
    head, 2 S^2 (qk + v) FLOPs a head and layer forward, half of them
    under the causal mask, 3x for forward and backward."""
    s = traffic["seq"]
    seqs = traffic["workers"] * traffic["batch"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = 3.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * (qk + cfg["v_head_dim"]) * s * s
    return seqs * (6.0 * matmul_params_per_token(cfg) * s + attn)


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the file."""
    from repro_torch.models.config import (Block, MLAConfig, ModelConfig,
                                           MoEConfig)
    dense, moe = _depths(cfg)
    f = cfg["moe_intermediate_size"]
    if cfg["scoring_func"] != "sigmoid" or cfg["n_group"] != 1 \
            or not cfg["norm_topk_prob"] or cfg["q_lora_rank"] is not None:
        raise ValueError("mla_moe builds sigmoid routing with one group, "
                         "normalised gates and no q-LoRA")
    return ModelConfig(
        name=cfg["name"], family="moe", d_model=cfg["hidden_size"],
        vocab_size=cfg["vocab_size"],
        blocks=(((Block("mla", "dense"),), dense),
                ((Block("mla", "moe"),), moe)),
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_attention_heads"],
        rope_theta=float(cfg["rope_theta"]),
        d_ff=cfg["intermediate_size"], mlp_act=cfg["hidden_act"],
        moe=MoEConfig(num_experts=cfg["router_experts"],
                      top_k=cfg["num_experts_per_tok"], d_expert=f,
                      shared_expert=cfg["n_shared_experts"] > 0,
                      d_shared=f * cfg["n_shared_experts"],
                      router_aux_weight=0.0, scoring="sigmoid",
                      routed_scaling=cfg["routed_scaling_factor"],
                      held=(cfg["held_first"], cfg["n_routed_experts"])),
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"])


def program_grad_fn(cfg: dict, stream):
    """The port's ``lm_grad_fn``.  The picks its routers make in the
    output check's ticks ride the stream to the reference: from then on
    ``stream.batch(tick)`` of such a tick also holds ``picks`` (W, B, S,
    MoE layers, K), which ``reference/mla_moe.py`` takes where its own
    top-k is a near tie."""
    from repro_torch.kernels.moe_experts import ops
    from repro_torch.models.transformer import Model, lm_grad_fn

    from ..harness import CHECK_ROUNDS
    grad_fn = lm_grad_fn(Model(model_config(cfg)), stream)
    kept: dict[int, torch.Tensor] = {}
    batch = stream.batch

    def kept_grad_fn(x_stacked, generator, worker_ids):
        tick = stream.tick
        if tick >= CHECK_ROUNDS:
            return grad_fn(x_stacked, generator, worker_ids)
        with ops.keep_picks() as picks:
            out = grad_fn(x_stacked, generator, worker_ids)
        kept[tick] = torch.stack(picks, dim=2)          # (W, T, L, K)
        return out

    def batch_with_picks(tick: int) -> dict:
        out = batch(tick)
        if tick in kept:
            out["picks"] = kept[tick].view(*out["inputs"].shape, -1,
                                           cfg["num_experts_per_tok"])
        return out

    stream.batch = batch_with_picks
    return kept_grad_fn
