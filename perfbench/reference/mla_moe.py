"""A DeepSeek-V3-style decoder as Kanana-2-30B-A3B publishes it, plain
PyTorch, float32 (TF32 off).  One worker's loss on this chip's share.

Per layer: RMSNorm; multi-head latent attention without q-LoRA: q
projected straight from d_model into 32 heads of 128 + 64 dims, the
latent c = RMSNorm of the first 512 of x W_dkv, its last 64 the shared
RoPE key; k = [c W_uk per head, the RoPE key], v = c W_uv; RoPE on the
64-dim parts rotating interleaved pairs (``rope_interleave``) at
``rope_theta``; a causal softmax over scores scaled by 1/sqrt(192); the
output projection; a residual.  Then RMSNorm and either the dense SwiGLU
MLP (the first ``first_k_dense_replace`` layers) or the MoE: the router's
sigmoid scores over all ``router_experts``, the top ``num_experts_per_tok``
selected by score + the selection bias (one group: ``noaux_tc`` selects
over all experts), their gates the unbiased scores of the picks, divided
by their sum and times ``routed_scaling_factor``; each held expert
computes exactly the rows of the tokens that picked it (gathered by
index: no capacity, nothing dropped) and adds them, gated; the shared
experts (one SwiGLU of ``n_shared_experts`` x the expert width) add once;
a residual.  A final RMSNorm and the untied head; the loss is the mean
cross-entropy over the padded vocabulary.

Departures from the published model, each stated in the configuration's
``assumed``: RMSNorm scales stored as their deviation from 1 (``x * inv *
(1 + s)``); the vocabulary sliced to its first eighth and padded to a
multiple of 256, the pad rows in the softmax; 5 of 48 layers; 8 of 128
routed experts held, the other chips' parts and the exchange left out;
the selection bias drawn from the seed and not updated (its published
rule runs outside the gradient); no multi-token prediction (the model has
none).

The program's picks.  Top-k selection is discrete: where the k-th and
the (k+1)-th biased scores of a token lie closer than the two sides'
float32 rounding (~1e-6), a sound program and this reference may pick
different experts, and a held expert's whole row then parts them.  So a
batch may carry ``picks`` (B, S, MoE layers, K), the experts the
program's routers picked for these tokens; where this reference's own
margin between its k-th and (k+1)-th biased score is under ``NEAR_TIE``
it takes the program's picks.  Anywhere else the two must pick the same
experts: a token whose picks differ there makes the loss NaN, which no
limit passes.

``fault`` plants a known fault in the MoE layers, as the output check's
calibration reads them: ``capacity`` drops every pick past a GShard
capacity of ceil(1.25 S K / E) rows an expert and sequence (in token
order); ``biased_gates`` takes the gates from the biased scores.
"""
from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from .transformer import _rms, _rope

FAULTS = ("capacity", "biased_gates")
CAPACITY_FACTOR = 1.25
# the least margin between the k-th and (k+1)-th biased score at which the
# program must pick this reference's experts: 10x the ~1e-6 that two
# float32 routers round apart by at d 2048
NEAR_TIE = 1e-5


def _swiglu(h: torch.Tensor, w: dict) -> torch.Tensor:
    return (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]


def _mla(h: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    b, s, _ = h.shape
    nh, nope, rope = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"])
    r, vd, theta = cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["rope_theta"]
    q = (h @ w["w_q"]).view(b, s, nh, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
    dkv = h @ w["w_dkv"]
    c = _rms(dkv[..., :r], w["kv_norm"], cfg["rms_norm_eps"])
    k_rope = _rope(dkv[..., r:].view(b, s, 1, rope), theta)
    k = torch.cat([(c @ w["w_uk"]).view(b, s, nh, nope),
                   k_rope.expand(b, s, nh, rope)], dim=-1)
    v = (c @ w["w_uv"]).view(b, s, nh, vd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(nope + rope)
    scores = scores.masked_fill(~causal, float("-inf"))
    att = torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)
    return att.reshape(b, s, nh * vd) @ w["wo"]


def route(h: torch.Tensor, w: dict, cfg: dict, fault: str | None = None,
          program: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(ids, gates), each (tokens, K), of h (tokens, D), and the number of
    tokens whose ``program`` picks (tokens, K) differ from these where
    the margin is ``NEAR_TIE`` or more (0 without them)."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(h @ w["router"])
    biased = scores + w["router_bias"]
    top = torch.sort(biased, dim=-1, descending=True, stable=True)
    ids, missed = top.indices[:, :k], 0
    if program is not None:
        near = top.values[:, k - 1] - top.values[:, k] < NEAR_TIE
        differ = (ids.sort(-1).values != program.sort(-1).values).any(-1)
        missed = int((differ & ~near).sum())
        ids = torch.where(near[:, None], program, ids)
    gates = torch.gather(biased if fault == "biased_gates" else scores, -1,
                         ids)
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return ids, gates * cfg["routed_scaling_factor"], missed


def moe(h: torch.Tensor, w: dict, cfg: dict, fault: str | None = None,
        program: torch.Tensor | None = None) -> tuple[torch.Tensor, int]:
    """This chip's share of a MoE layer on h (B, S, D): its held experts'
    gated outputs and the shared experts'; and ``route``'s count of
    ``program`` (B, S, K) picks that differ where the margin is clear."""
    b, s, d = h.shape
    flat = h.reshape(b * s, d)
    ids, gates, missed = route(flat, w, cfg, fault, None if program is None
                               else program.reshape(b * s, -1))
    out = _swiglu(flat, w["shared"])
    cap = math.ceil(CAPACITY_FACTOR * s * ids.shape[1]
                    / cfg["router_experts"])
    for j in range(cfg["n_routed_experts"]):
        hit = ids == cfg["held_first"] + j               # (tokens, K)
        tok, slot = hit.nonzero(as_tuple=True)           # in token order
        if fault == "capacity":
            # the j-th pick of a sequence past its capacity is dropped
            seq = tok // s
            rank = torch.cumsum(F.one_hot(seq, b), 0)
            keep = rank[torch.arange(len(seq), device=h.device), seq] <= cap
            tok, slot = tok[keep], slot[keep]
        expert = {k: w[f"moe_{k[2:]}"][j]
                  for k in ("w_gate", "w_up", "w_down")}
        rows = _swiglu(flat[tok], expert) * gates[tok, slot][:, None]
        out = out.index_add(0, tok, rows)
    return out.view(b, s, d), missed


def loss(p: dict, cfg: dict, batch: dict, fault: str | None = None
         ) -> torch.Tensor:
    """Mean cross-entropy of one worker's (B, S) tokens; NaN where the
    batch's ``picks`` differ from this reference's at a clear margin."""
    eps = cfg["rms_norm_eps"]
    tokens = batch["inputs"]
    picks = batch.get("picks")
    b, s = tokens.shape
    x = p["embed"]["tok"][tokens]
    layer, missed = 0, 0
    for group in p["groups"]:
        layers = group["b0"]
        for i in range(layers["norm1"].shape[0]):
            att = {k: v[i] for k, v in layers["mixer"].items()}
            x = x + _mla(_rms(x, layers["norm1"][i], eps), att, cfg)
            h = _rms(x, layers["norm2"][i], eps)
            mlp = {k: (v[i] if isinstance(v, torch.Tensor)
                       else {kk: vv[i] for kk, vv in v.items()})
                   for k, v in layers["mlp"].items()}
            if "router" not in mlp:
                x = x + _swiglu(h, mlp)
                continue
            out, m = moe(h, mlp, cfg, fault,
                         None if picks is None else picks[:, :, layer])
            x, layer, missed = x + out, layer + 1, missed + m
    logits = _rms(x, p["final_norm"], eps) @ p["head"]["w"]
    value = F.cross_entropy(logits.reshape(b * s, -1),
                            batch["labels"].reshape(b * s))
    if missed:
        print(f"perfbench: the program's routers picked other experts than "
              f"the reference's for {missed} tokens at a top-k margin of "
              f"{NEAR_TIE} or more", file=sys.stderr)
        value = value * float("nan")
    return value
