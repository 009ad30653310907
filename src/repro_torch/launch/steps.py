"""Step functions, ported from ``repro.launch.steps``: the synchronous train
step, the prefill step and the serve (decode) step.

The JAX package's steps are jit-able functions with sharding hints; here
they are plain functions on tensors.  ``forward_only()`` becomes
``torch.no_grad()``, which keeps no graph (and lets the flash kernel, which
has no backward, run).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.tree import PyTree, tree_flatten, tree_leaves, tree_map
from ..models.transformer import Model
from ..optim import clip_by_global_norm, sgd
from ..optim.optimizers import Optimizer, OptState


class TrainState(NamedTuple):
    params: PyTree
    opt: OptState


def _value_and_grad(model: Model, params: PyTree, batch: dict,
                    remat: bool):
    """((loss, metrics), grads) of ``model.loss`` at ``params``, by
    ``torch.autograd.grad`` on detached copies of the leaves (a leaf the
    loss does not reach gets a zero gradient)."""
    leaves, treedef = tree_flatten(params)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = model.loss(treedef.unflatten(ps), batch, remat=remat)
    grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                materialize_grads=True)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            treedef.unflatten(list(grads)))


def make_train_step(model: Model, optimizer: Optimizer | None = None,
                    lr: float = 1e-2, remat: bool = True,
                    grad_clip: float | None = None,
                    num_microbatches: int = 1, accum_dtype: Any = None):
    """The synchronous train step ``(state, batch) -> (state, metrics)``
    and its optimizer (``sgd()``, the paper's, by default).

    ``num_microbatches`` > 1 accumulates gradients over micro-batches: the
    batch leaves arrive with a leading (num_microbatches,) axis (shaped by
    the caller, not reshaped here).  Gradients accumulate in
    ``accum_dtype`` (default: each parameter's dtype), are divided by the
    count and cast to the dtype of the first parameter leaf, as the JAX
    step does; loss and metrics are the micro-batches' means.  The lr is an
    f32 tensor, as in the JAX step."""
    optimizer = optimizer or sgd()  # the paper's optimizer

    def train_step(state: TrainState, batch: dict):
        if num_microbatches == 1:
            (loss, metrics), grads = _value_and_grad(model, state.params,
                                                     batch, remat)
        else:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype or p.dtype, device=p.device),
                state.params)
            losses, metricses = [], []
            for i in range(num_microbatches):
                micro = tree_map(lambda a, i=i: a[i], batch)
                (lo, me), g = _value_and_grad(model, state.params, micro,
                                              remat)
                acc = tree_map(lambda a, gg: a + gg.to(a.dtype), acc, g)
                losses.append(lo)
                metricses.append(me)
            dtype = tree_leaves(state.params)[0].dtype
            grads = tree_map(lambda g: (g / num_microbatches).to(dtype),
                             acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        with torch.no_grad():
            if grad_clip is not None:
                grads = clip_by_global_norm(grads, grad_clip)
            lr32 = torch.tensor(lr, dtype=torch.float32,
                                device=loss.device)
            params, opt = optimizer.update(grads, state.opt, state.params,
                                           lr32)
        return TrainState(params, opt), {"loss": loss, **metrics}

    return train_step, optimizer


def make_prefill_step(model: Model):
    def prefill_step(params: dict, batch: dict):
        with torch.no_grad():
            logits, _, _ = model.forward(params, batch["inputs"])
        return logits

    return prefill_step


def make_serve_step(model: Model):
    """``(params, caches, inputs, pos) -> (logits, new caches)``: one
    ``Model.decode_step`` with no graph kept."""
    def serve_step(params: dict, caches: list, inputs, pos):
        with torch.no_grad():
            return model.decode_step(params, inputs, pos, caches)

    return serve_step
