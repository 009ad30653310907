"""The composable decoder stack, ported from ``repro.models.transformer``:
the training / prefill forward, the loss (with the MoE aux loss and
DeepSeek-V3's multi-token prediction), the batched ``grad_fn`` that
``Simulator`` replays, and single-token decode against per-layer caches
(``init_cache``, ``decode_step``, ``prefill``).

Every mixer and mlp of the JAX package is here: the ``attn`` (GQA, RoPE,
qk-norm, windows, both ``attention_impl`` values), ``mla``, ``ssd`` and
``rglru`` mixers, the ``dense``, ``moe``, ``moe+dense`` and ``none``
mlps, token and embedding inputs, tied or separate heads, codebooks.

Parameters are nested dicts in the JAX package's layout: every layer
group's params are stacked along a leading ``repeat`` axis, ``"head"`` is
``{}`` when the embeddings are tied, and the leaves flatten in JAX's sorted
order (``core.tree``).  The caches keep the same layout: one entry per
layer group of ``{"b{i}": <the mixer's cache>}``, each leaf stacked on the
``repeat`` axis, so batch is axis 1.  The forward and decode passes are
Python loops over each group's ``repeat`` axis where the JAX package runs
``lax.scan``, and ``prefill`` is a loop of ``decode_step``s.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from ..analysis import tracing
from ..core.tree import PyTree, tree_flatten, tree_leaves, tree_map
from ..device import resolve_device
from . import attention, rglru, ssm
from .config import Block, ModelConfig
from .layers import (apply_lm_head, apply_mlp, apply_moe, dense_init,
                     dtype_of, embed_inputs, init_embedding, init_lm_head,
                     init_mlp, init_moe, init_rmsnorm, rmsnorm)


# ----------------------------------------------------------------- per block

def init_block(generator: torch.Generator, cfg: ModelConfig, block: Block
               ) -> dict:
    dtype = dtype_of(cfg.param_dtype)
    dev = generator.device
    p: dict = {"norm1": init_rmsnorm(cfg.d_model, dtype, dev)}
    if block.mixer == "attn":
        p["mixer"] = attention.init_attention(generator, cfg, dtype)
    elif block.mixer == "mla":
        p["mixer"] = attention.init_mla(generator, cfg, dtype)
    elif block.mixer == "ssd":
        p["mixer"] = ssm.init_ssd(generator, cfg, dtype)
    elif block.mixer == "rglru":
        p["mixer"] = rglru.init_rglru(generator, cfg, dtype)
    else:
        raise ValueError(block.mixer)
    if block.mlp != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, dev)
        if block.mlp == "dense":
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                cfg.mlp_act)
        else:  # moe / moe+dense
            p["mlp"] = init_moe(generator, cfg.d_model, cfg.moe, dtype,
                                cfg.mlp_act)
    return p


def apply_block(p: dict, cfg: ModelConfig, block: Block, x: torch.Tensor,
                positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual block (the mixer, then the mlp if any); returns (x,
    aux_loss), aux 0 without MoE."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if block.mixer == "attn":
        h = attention.apply_attention(p["mixer"], cfg, h, positions,
                                      block.window)
    elif block.mixer == "mla":
        h = attention.apply_mla(p["mixer"], cfg, h, positions, block.window)
    elif block.mixer == "ssd":
        h = ssm.apply_ssd(p["mixer"], cfg, h)
    elif block.mixer == "rglru":
        h = rglru.apply_rglru(p["mixer"], cfg, h)
    x = x + h
    if block.mlp != "none":
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if block.mlp == "dense":
            h = apply_mlp(p["mlp"], h, cfg.mlp_act)
        else:
            h, aux = apply_moe(p["mlp"], h, cfg.moe, cfg.mlp_act)
        x = x + h
    return x, aux


def init_block_cache(cfg: ModelConfig, block: Block, batch: int,
                     length: int, dtype, device=None) -> dict:
    if block.mixer == "attn":
        return attention.init_attn_cache(cfg, batch, length, block.window,
                                         dtype, device)
    if block.mixer == "mla":
        return attention.init_mla_cache(cfg, batch, length, block.window,
                                        dtype, device)
    if block.mixer == "ssd":
        return ssm.init_ssd_cache(cfg, batch, dtype, device)
    if block.mixer == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(block.mixer)


def decode_block(p: dict, cfg: ModelConfig, block: Block, x: torch.Tensor,
                 pos, cache: dict) -> tuple[torch.Tensor, dict]:
    """``apply_block`` for one token against the layer's cache (a MoE's
    aux is dropped, as the JAX package drops it)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if block.mixer == "attn":
        h, cache = attention.decode_attention(p["mixer"], cfg, h, pos, cache,
                                              block.window)
    elif block.mixer == "mla":
        h, cache = attention.decode_mla(p["mixer"], cfg, h, pos, cache,
                                        block.window)
    elif block.mixer == "ssd":
        h, cache = ssm.decode_ssd(p["mixer"], cfg, h, pos, cache)
    elif block.mixer == "rglru":
        h, cache = rglru.decode_rglru(p["mixer"], cfg, h, pos, cache)
    x = x + h
    if block.mlp != "none":
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if block.mlp == "dense":
            h = apply_mlp(p["mlp"], h, cfg.mlp_act)
        else:
            h, _ = apply_moe(p["mlp"], h, cfg.moe, cfg.mlp_act)
        x = x + h
    return x, cache


def mtp_block(cfg: ModelConfig) -> Block:
    """The multi-token prediction block: a GQA + dense block where the
    config has a d_ff, else the model's first block."""
    return Block("attn", "dense") if cfg.d_ff else cfg.all_blocks()[0]


# --------------------------------------------------------------------- model

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator) -> dict:
        """Random weights on the generator's device.  Structure, shapes and
        dtypes equal the JAX ``Model.init``'s; the values come from the
        generator.  ``layers.SHAPE_ONLY`` in the generator's place gives
        the same tree on the meta device: no draws, no storage."""
        cfg = self.cfg
        cfg.validate()
        dtype = dtype_of(cfg.param_dtype)
        params: dict = {
            "embed": init_embedding(generator, cfg, dtype),
            "final_norm": init_rmsnorm(cfg.d_model, dtype, generator.device),
            "head": init_lm_head(generator, cfg, dtype),
            "groups": [],
        }
        for unit, repeat in cfg.blocks:
            layers = [{f"b{i}": init_block(generator, cfg, b)
                       for i, b in enumerate(unit)} for _ in range(repeat)]
            params["groups"].append(
                tree_map(lambda *xs: torch.stack(xs), *layers))
            del layers
        if cfg.mtp:
            params["mtp"] = {
                "proj": dense_init(generator, 2 * cfg.d_model,
                                   (2 * cfg.d_model, cfg.d_model), dtype),
                "norm": init_rmsnorm(2 * cfg.d_model, dtype,
                                     generator.device),
                "block": init_block(generator, cfg, mtp_block(cfg)),
            }
        return params

    def forward(self, params: dict, inputs: torch.Tensor, *,
                remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """inputs: tokens (B,S) int or embeddings (B,S,D).

        Returns (logits, aux_loss, final_hidden); aux is the MoE layers'
        summed aux loss, 0 without MoE.  With ``remat`` each unit (one
        step of a group's ``repeat`` loop, the blocks JAX checkpoints
        together) runs under ``torch.utils.checkpoint``: the backward
        keeps only the unit's inputs and runs the unit's forward again.
        Under an active tracer a ``model.layers`` counter sample gives
        the layer-stacked leaves unbound and the layer views served."""
        cfg = self.cfg
        x = embed_inputs(params["embed"], cfg, inputs)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        n_leaves = n_slices = 0
        for (unit, repeat), group_p in zip(cfg.blocks, params["groups"]):

            def unit_fn(x, layer_p, unit=unit):
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
                for i, blk in enumerate(unit):
                    x, a = apply_block(layer_p[f"b{i}"], cfg, blk, x,
                                       positions)
                    aux = aux + a
                return x, aux

            # each leaf unbound along its layer axis once: the backward
            # stacks the layers' gradients in one write, where a slice
            # ``a[r]`` a layer gives a zero-filled full gradient to sum
            leaves, spec = tree_flatten(group_p)
            views = [torch.unbind(a, 0) for a in leaves]
            n_leaves += len(leaves)
            n_slices += len(leaves) * repeat
            auxs = []
            for r in range(repeat):
                layer_p = spec.unflatten([v[r] for v in views])
                if remat:
                    x, aux = checkpoint(unit_fn, x, layer_p,
                                        use_reentrant=False)
                else:
                    x, aux = unit_fn(x, layer_p)
                auxs.append(aux)
            aux_total = aux_total + torch.stack(auxs).sum()
        tracing.count("model.layers", leaves=n_leaves, slices=n_slices)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = apply_lm_head(params["head"], params["embed"], cfg, x)
        return logits, aux_total, x

    def loss(self, params: dict, batch: dict, *, remat: bool = False
             ) -> tuple[torch.Tensor, dict]:
        """batch: {"inputs": tokens/embeddings, "labels": (B,S) or
        (B,S,C)}; CE in f32 over the ``padded_vocab`` logits, plus the MoE
        aux loss and, for token inputs of an ``mtp`` config, 0.3 times the
        multi-token prediction loss.  Returns (loss, {"ce", "aux"[,
        "mtp"]})."""
        cfg = self.cfg
        logits, aux, h = self.forward(params, batch["inputs"], remat=remat)
        labels = batch["labels"]
        b, s = labels.shape[:2]
        logits = logits.reshape(b, s, cfg.num_codebooks, cfg.padded_vocab)
        loss = _ce(logits, labels)
        metrics = {"ce": loss, "aux": aux}
        if cfg.mtp and cfg.input_mode == "tokens":
            mtp = self._mtp_loss(params, batch, h)
            metrics["mtp"] = mtp
            loss = loss + 0.3 * mtp
        return loss + aux, metrics

    def _mtp_loss(self, params: dict, batch: dict, h: torch.Tensor
                  ) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: one extra block predicting
        token t + 2 from [h_t ; emb(tok_{t+1})]."""
        cfg = self.cfg
        tok = batch["inputs"]
        b, s = tok.shape
        emb_next = params["embed"]["tok"][tok[:, 1:]]
        hh = torch.cat([h[:, :-1], emb_next.to(h.dtype)], dim=-1)
        hh = rmsnorm(hh, params["mtp"]["norm"], cfg.norm_eps)
        hh = hh @ params["mtp"]["proj"]
        positions = torch.arange(s - 1, dtype=torch.int32,
                                 device=hh.device).expand(b, s - 1)
        hh, _ = apply_block(params["mtp"]["block"], cfg, mtp_block(cfg), hh,
                            positions)
        logits = apply_lm_head(params["head"], params["embed"], cfg, hh)
        logits = logits.reshape(b, s - 1, cfg.num_codebooks,
                                cfg.padded_vocab)
        # labels are the inputs shifted by 1: the targets are them shifted
        # by 1 more
        return _ce(logits, batch["labels"][:, 1:])

    def init_cache(self, batch: int, length: int, dtype=None,
                   device="cuda") -> list:
        """Empty caches for ``batch`` sequences of up to ``length``
        positions, in the compute dtype unless ``dtype`` is named, on the
        card unless the caller names the CPU."""
        cfg = self.cfg
        dtype = dtype or dtype_of(cfg.compute_dtype)
        dev = resolve_device(device)
        caches = []
        for unit, repeat in cfg.blocks:
            one = {f"b{i}": init_block_cache(cfg, b, batch, length, dtype,
                                             dev)
                   for i, b in enumerate(unit)}
            caches.append(tree_map(
                lambda a: a.unsqueeze(0).repeat(
                    (repeat,) + (1,) * a.dim()), one))
        return caches

    def decode_step(self, params: dict, inputs: torch.Tensor, pos,
                    caches: list) -> tuple[torch.Tensor, list]:
        """inputs: tokens (B, 1) or embeddings (B, 1, D); ``pos`` a Python
        int, a 0-d tensor or (B,) per-sequence positions (continuous
        batching: RoPE, cache row and visibility mask are per sequence).

        Returns (logits (B, 1, V*C), new caches); the caches passed in are
        left as they were."""
        cfg = self.cfg
        x = embed_inputs(params["embed"], cfg, inputs)
        new_caches = []
        for (unit, repeat), group_p, cache in zip(cfg.blocks,
                                                  params["groups"], caches):
            layers = []
            for r in range(repeat):
                layer_p = tree_map(lambda a, r=r: a[r], group_p)
                new_c = {}
                for i, blk in enumerate(unit):
                    x, new_c[f"b{i}"] = decode_block(
                        layer_p[f"b{i}"], cfg, blk, x, pos,
                        tree_map(lambda a, r=r: a[r], cache[f"b{i}"]))
                layers.append(new_c)
            new_caches.append(tree_map(lambda *xs: torch.stack(xs),
                                       *layers))
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = apply_lm_head(params["head"], params["embed"], cfg, x)
        return logits, new_caches

    def prefill(self, params: dict, inputs: torch.Tensor, caches: list,
                pos0=0) -> tuple[torch.Tensor, list]:
        """Chunked prefill: the (B, P) prompt (or (B, P, D) embeddings)
        fed through ``decode_step`` at positions ``pos0 .. pos0 + P - 1``,
        one token a step (the JAX package scans the same steps).  Returns
        (logits (B, 1, V*C) at the LAST position, filled caches): exactly
        what step ``P - 1`` of the token-by-token loop returns."""
        p_len = inputs.shape[1]
        for t in range(p_len - 1):
            _, caches = self.decode_step(params, inputs[:, t:t + 1],
                                         pos0 + t, caches)
        return self.decode_step(params, inputs[:, p_len - 1:p_len],
                                pos0 + p_len - 1, caches)

    @staticmethod
    def param_count(params: dict) -> int:
        return sum(a.numel() for a in tree_leaves(params))


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean f32 cross-entropy of (B, S, C, V) logits against (B, S) or (B,
    S, C) labels."""
    if labels.dim() == 2:
        labels = labels[..., None]
    lp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0].mean()


def lm_grad_fn(model: Model, stream):
    """Batched ``grad_fn`` for ``Simulator`` (see ``simulator.GradFn``).

    ``stream.sample_workers(generator, n)`` draws one batch per worker,
    ``{"inputs": (n, B, S), "labels": (n, B, S)}``, outside the vmap; the
    per-worker losses are one ``torch.func.vmap`` of the loss over the
    worker-stacked parameters, and their gradients one plain
    ``torch.autograd.grad`` of the losses' sum (the workers share no
    parameter, so each worker's gradient is its own loss's).  Plain
    autograd runs each op's backward once on the stacked tensors, where
    ``vmap(grad_and_value)`` takes every ``autograd.Function`` (RMSNorm,
    the products, the experts) through the transforms' Python a call.  A
    leaf the loss does not read gets a zero gradient, as
    ``grad_and_value`` gives it.
    """
    def loss_one(p: PyTree, inputs, labels):
        return model.loss(p, {"inputs": inputs, "labels": labels})[0]

    per_worker = vmap(loss_one)

    def grad_fn(x_stacked, generator, worker_ids):
        batch = stream.sample_workers(generator, worker_ids.shape[0])
        leaves, spec = tree_flatten(x_stacked)
        params = [leaf.detach().requires_grad_() for leaf in leaves]
        with torch.enable_grad():
            losses = per_worker(spec.unflatten(params),
                                batch["inputs"], batch["labels"])
            grads = torch.autograd.grad(losses.sum(), params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return losses.detach(), spec.unflatten(grads)

    return grad_fn
