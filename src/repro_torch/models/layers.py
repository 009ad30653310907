"""Common layers: norms, MLPs, embeddings and the capacity-based top-k MoE,
ported from ``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX package's keys, shapes
and dtypes; initialisers draw from a ``torch.Generator`` on its device, so
their values differ from ``jax.random``'s (carry JAX weights with
``convert``).  ``SHAPE_ONLY`` in the generator's place gives the same
leaves on the meta device, with no draws.  The sharding hints of the JAX package are dropped: one card
has no mesh.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..analysis import tracing
from ..kernels.dense_f32.ops import dense
from ..kernels.moe_experts import ops as experts
from .config import ModelConfig, MoEConfig


def dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


# ------------------------------------------------------------------- inits

class ShapeOnly:
    """Takes a generator's place in the ``init_*`` functions and
    ``Model.init``: every leaf is made on the meta device with its shape
    and dtype, nothing is drawn and nothing is allocated."""

    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def dense_init(generator: torch.Generator, fan_in: int, shape, dtype
               ) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by 1 / sqrt(fan_in), drawn in
    f32 and cast to ``dtype`` (a meta tensor of ``dtype`` for
    ``SHAPE_ONLY``)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # scaled in place: one f32 temporary, not two, for a 7.5 GB (bf16)
    # expert tensor
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * 0.02).to(dtype)


# -------------------------------------------------------------------- norms

def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """rsqrt(mean x² + eps) in f32, the sum of squares as a dot (the JAX
    layer's einsum, so that both count its FLOPs)."""
    x32 = x.float()
    var = torch.einsum("...d,...d->...", x32, x32)[..., None] / x.shape[-1]
    return torch.rsqrt(var + eps)


class _RMSNorm(torch.autograd.Function):
    """The JAX layer's ``_rmsnorm_fwd`` / ``_rmsnorm_bwd``, line for line.
    The forward also returns ``inv`` (non-differentiable) so that the
    backward reads it; ``generate_vmap_rule`` lets ``torch.func`` run it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, eps):
        dt = x.dtype
        inv = _rms_inv(x, eps).to(dt)
        return (x * inv) * (1.0 + scale.to(dt)), inv

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _ = inputs
        inv = output[1]
        ctx.mark_non_differentiable(inv)
        ctx.save_for_backward(x, scale, inv)

    @staticmethod
    def backward(ctx, g, _):
        x, scale, inv = ctx.saved_tensors
        dt = x.dtype
        gs = g * (1.0 + scale.to(dt))
        # the row scalar sum(g * s' * x) in f32 as one dot
        dot = torch.einsum("...d,...d->...", gs.float(), x.float())
        coef = (dot[..., None] / x.shape[-1]).to(dt) * (inv * inv * inv)
        gx = gs * inv - x * coef
        gscale = (g * x * inv).float()
        if g.dim() > 1:       # JAX sums over every axis but the last
            gscale = gscale.sum(dim=tuple(range(g.dim() - 1)))
        return gx, gscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with the JAX layer's rounding and its custom VJP.

    Forward: the sum of squares in f32 as a dot, ``inv`` rounded to x's
    dtype, then ``(x * inv) * (1 + scale)`` in x's dtype.  Backward
    (``_RMSNorm``): every cotangent in x's dtype, only the row dot
    ``(g * (1 + scale)) · x`` taken in f32, and the scale's gradient
    summed in f32 and cast to the scale's dtype; at bf16 it is bit for bit
    JAX's, where autograd through the f32 upcast was not."""
    return _RMSNorm.apply(x, scale, eps)[0]


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
    up = dense(x, p["w_up"])
    if act == "silu":
        h = F.silu(dense(x, p["w_gate"])) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return dense(h, p["w_down"])


# ---------------------------------------------------------------------- MoE

def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype, act: str = "silu") -> dict:
    """Stacked experts ``(E, d, f)`` / ``(E, f, d)``, the router in f32 (for
    a stable softmax), and the optional shared expert and parallel dense
    mlp."""
    d_e = cfg.d_expert or d_model * 4
    e = cfg.num_experts
    held = cfg.held[1] if cfg.held else e   # the router still scores all e
    p = {
        "router": dense_init(generator, d_model, (d_model, e),
                             torch.float32),
        "moe_up": dense_init(generator, d_model, (held, d_model, d_e),
                             dtype),
        "moe_down": dense_init(generator, d_e, (held, d_e, d_model), dtype),
    }
    if act == "silu":
        p["moe_gate"] = dense_init(generator, d_model, (held, d_model, d_e),
                                   dtype)
    if cfg.scoring == "sigmoid":
        # DeepSeek-V3's selection bias, published at 0; training moves it
        # by a rule outside the gradient (its gradient is 0)
        p["router_bias"] = torch.zeros((e,), dtype=torch.float32,
                                       device=generator.device)
    if cfg.shared_expert:
        p["shared"] = init_mlp(generator, d_model, cfg.d_shared or d_e,
                               dtype, act)
    if cfg.dense_d_ff:
        p["dense"] = init_mlp(generator, d_model, cfg.dense_d_ff, dtype, act)
    return p


def moe_capacity(s: int, cfg: MoEConfig) -> int:
    """Rows a group (one batch row of S tokens) keeps for each expert."""
    return max(1, int(np.ceil(s * cfg.top_k / cfg.num_experts
                              * cfg.capacity_factor)))


def moe_route(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, D) -> (probs (B, S, E) f32, topw (B, S, K) in x's dtype,
    topi (B, S, K)).  The router product runs in x's dtype, the softmax in
    f32.  The top k come from a stable descending sort, so that equal
    probabilities keep the lower expert first, as ``lax.top_k`` does; the
    weights are renormalised over the k, then cast to x's dtype.

    ``scoring == "sigmoid"`` (DeepSeek-V3's ``noaux_tc`` with one group):
    the scores are sigmoids of the logits, the k experts are selected by
    score + ``router_bias``, and their gates are the unbiased scores,
    normalised over the k and times ``routed_scaling``."""
    logits = (x @ p["router"].to(x.dtype)).float()
    if cfg.scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        _, topi = torch.sort(probs + p["router_bias"].float(), dim=-1,
                             descending=True, stable=True)
        topi = topi[..., :cfg.top_k]
        topw = torch.gather(probs, -1, topi)
    else:
        probs = torch.softmax(logits, dim=-1)
        topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topw, topi = topw[..., :cfg.top_k], topi[..., :cfg.top_k]
    topw = topw / topw.sum(dim=-1, keepdim=True) * cfg.routed_scaling
    return probs, topw.to(x.dtype), topi


def _expert_mask(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """(..., N) expert ids -> (..., N, E) bool, True at each id's expert:
    the one-hot that ``F.one_hot`` would give, without its host-side range
    check (so it runs under ``torch.func.vmap``)."""
    return flat_e[..., None] == torch.arange(e, device=flat_e.device)


def _dispatch_group(xt: torch.Tensor, topi: torch.Tensor, e: int, c: int):
    """Per-group dispatch, on an explicit group axis: xt (G, T, D), topi
    (G, T, K) -> buffer (G, E, C, D), dest (G, T, K), keep (G, T, K).

    The rank of each (token, k) within its expert is the running count of
    earlier picks of that expert in (token, k) order, which is the rank a
    stable sort by expert gives (the JAX package's ``argsort`` and
    ``searchsorted``).  A pick past capacity is dropped: it is written to a
    spare row E * C, cut off at the end.  K scatters of (T, D), k = 0 .. K
    - 1, out of place; kept destinations are unique."""
    g, t, d = xt.shape
    k = topi.shape[-1]
    flat_e = topi.reshape(g, t * k)
    onehot = _expert_mask(flat_e, e)
    slot = (torch.cumsum(onehot.int(), dim=1) * onehot).sum(-1) - 1
    keep = (slot < c).reshape(g, t, k)
    dest = (flat_e * c + slot).reshape(g, t, k)
    buf = xt.new_zeros((g, e * c + 1, d))
    for j in range(k):
        sdest = torch.where(keep[..., j], dest[..., j], e * c)
        buf = buf.scatter(1, sdest[..., None].expand(g, t, d), xt)
    return buf[:, :e * c].reshape(g, e, c, d), dest, keep


def _combine_group(out_e: torch.Tensor, dest: torch.Tensor,
                   keep: torch.Tensor, topw: torch.Tensor) -> torch.Tensor:
    """K gathers of (T, D), weighted and summed in the activation dtype, k
    = 0 .. K - 1: out_e (G, E, C, D), dest / keep / topw (G, T, K) -> (G,
    T, D).  A dropped pick gathers an appended zero row."""
    g, e, c, d = out_e.shape
    t, k = dest.shape[1:]
    flat = torch.cat([out_e.reshape(g, e * c, d),
                      out_e.new_zeros((g, 1, d))], dim=1)
    out = out_e.new_zeros((g, t, d))
    for j in range(k):
        sdest = torch.where(keep[..., j], dest[..., j], e * c)
        rows = torch.gather(flat, 1, sdest[..., None].expand(g, t, d))
        out = out + rows * (topw[..., j:j + 1]
                            * keep[..., j:j + 1]).to(out.dtype)
    return out


def _expert_products(p: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The experts on the dispatched buffer (G, E, C, D) -> (G, E, C, D):
    one ``bmm`` a weight, on the buffer laid out as (E, G * C, D) against
    the stacked weights as they are (no copy of a weight)."""
    g, e, c, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, g * c, d)
    up = torch.bmm(xe, p["moe_up"])
    if act == "silu":
        h = F.silu(torch.bmm(xe, p["moe_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = torch.bmm(h, p["moe_down"])
    return out.reshape(e, g, c, d).transpose(0, 1)


def apply_moe(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str = "silu"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise capacity-based top-k MoE (GShard-style dispatch), the
    groups the batch rows: x (B, S, D) -> (out, aux_loss f32).  With
    ``held`` every pick of a held expert is computed
    (``kernels.moe_experts``: no capacity, nothing dropped); the layer
    then adds only its held experts' part, and the shared expert and dense
    mlp once.

    aux is the Switch load-balance loss over the whole batch,
    ``router_aux_weight * E * sum_e mean_prob_e * count_e / (B * S * K)``,
    the counts taken from the expert mask (no ``bincount``)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    with tracing.span("moe.route"):
        probs, topw, topi = moe_route(p, x, cfg)
        me = probs.mean(dim=(0, 1))
        counts = _expert_mask(topi.reshape(-1), e).float().sum(0)
        aux = cfg.router_aux_weight * e * torch.sum(me * counts
                                                    / (b * s * k))
        if cfg.held is not None:
            e0, n = cfg.held
            ids = topi.reshape(1, b * s, k)
            routing = experts.moe_route(ids, e0, n)
    if cfg.held is not None:
        if act != "silu":
            raise ValueError("the held experts are SwiGLU (silu) only")
        out = experts.moe_experts(
            x.reshape(1, b * s, d), topw.reshape(1, b * s, k), ids, routing,
            p["moe_gate"][None], p["moe_up"][None], p["moe_down"][None],
            e0).reshape(b, s, d)
    else:
        c = moe_capacity(s, cfg)
        buf, dest, keep = _dispatch_group(x, topi, e, c)
        out_e = _expert_products(p, buf, act)
        out = _combine_group(out_e, dest, keep, topw)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x, act)
    return out, aux


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
        return dense(x, embed_p["tok"].T.to(x.dtype))
    return dense(x, head_p["w"])
