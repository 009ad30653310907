"""Optimizers as (init, update) pairs on pytrees of tensors.

The paper trains with SGD + heavy-ball momentum 0.9 + weight decay 5e-4
(decoupled from the learnable norm scales, following Goyal et al.); ``sgd``
reproduces that.  ``adamw`` is provided for the LM substrate.  Ported from
``repro.optim.optimizers`` with the same order of operations: at bf16 every
Python scalar that multiplies a tensor is first rounded to the tensor's
dtype (``dtype_scalar``), as JAX binds a weak scalar, so the two agree bit
for bit.

The update is elementwise per leaf, so it also runs on worker-stacked
leaves (W, ...) with a (W,) step counter, which is what ``jax.vmap`` of
the update computes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..core.tree import (PyTree, tree_flatten, tree_flatten_with_path,
                         tree_leaves, tree_map)
from ..kernels.a2cid2_mixing.ref import dtype_scalar


class OptState(NamedTuple):
    step: torch.Tensor    # () int32, or (W,) for worker-stacked params
    mu: PyTree            # momentum / first moment
    nu: PyTree | None     # second moment (adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree, Any],
                     tuple[PyTree, OptState]]


def _is_norm_scale(path: tuple) -> bool:
    """Heuristic: 1-D leaves named *norm*/scale/bias are exempt from weight
    decay (paper Sec 4.1, following [16]).  A list or tuple position adds
    an empty name, as JAX's ``SequenceKey`` does."""
    names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
    joined = "/".join(str(n) for n in names).lower()
    return any(t in joined for t in ("norm", "gn", "bias", "b_a", "b_x",
                                     "lam", "dt_bias", "a_log", "slot_pos"))


def weight_decay_mask(params: PyTree) -> list[float]:
    """Per leaf, in the tree's leaf order: 0.0 for a leaf exempt from weight
    decay, 1.0 otherwise."""
    return [0.0 if _is_norm_scale(p) else 1.0
            for p, _ in tree_flatten_with_path(params)[0]]


def _lr_as(lr, dtype: torch.dtype):
    """The f32 learning rate cast to ``dtype`` (JAX's ``lr.astype(dt)``):
    a Python float stays one, a tensor stays on its device."""
    if torch.is_tensor(lr):
        return lr.to(torch.float32).to(dtype)
    return dtype_scalar(float(np.float32(lr)), dtype)


def _lead(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A per-step scalar (or a (W,) per-worker vector) shaped to broadcast
    against a leaf (or a worker-stacked leaf)."""
    return v.reshape(v.shape + (1,) * (p.dim() - v.dim()))


def sgd(momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        tree_map(torch.zeros_like, params), None)

    def update(grads, state, params, lr):
        wd_mask = weight_decay_mask(params)
        flat_g, treedef = tree_flatten(grads)
        flat_p = treedef.flatten_up_to(params)
        flat_mu = treedef.flatten_up_to(state.mu)
        new_mu, new_p = [], []
        for g, p, mu, m in zip(flat_g, flat_p, flat_mu, wd_mask):
            # all update math in the param dtype (the lr scalar is cast,
            # not the tensors)
            dt = p.dtype
            g = g.to(dt) + dtype_scalar(weight_decay * m, dt) * p
            mu = dtype_scalar(momentum, dt) * mu.to(dt) + g
            d = (g + dtype_scalar(momentum, dt) * mu) if nesterov else mu
            new_mu.append(mu)
            new_p.append(p - _lr_as(lr, dt) * d)
        return (treedef.unflatten(new_p),
                OptState(state.step + 1, treedef.unflatten(new_mu), None))

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        # fp32 moments regardless of param dtype (mixed-precision master
        # stats)
        dev = tree_leaves(params)[0].device
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        zeros, tree_map(torch.clone, zeros))

    def update(grads, state, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=t.device), t)
        lr32 = lr.to(torch.float32) if torch.is_tensor(lr) \
            else float(np.float32(lr))
        wd_mask = weight_decay_mask(params)
        flat_g, treedef = tree_flatten(grads)
        flat_p = treedef.flatten_up_to(params)
        flat_mu = treedef.flatten_up_to(state.mu)
        flat_nu = treedef.flatten_up_to(state.nu)
        new_mu, new_nu, new_p = [], [], []
        for g, p, mu, nu, m in zip(flat_g, flat_p, flat_mu, flat_nu,
                                   wd_mask):
            g32 = g.to(torch.float32)
            mu = b1 * mu + (1 - b1) * g32
            nu = b2 * nu + (1 - b2) * g32 * g32
            upd = (mu / _lead(c1, mu)) / (torch.sqrt(nu / _lead(c2, nu))
                                          + eps)
            upd = upd + weight_decay * m * p.to(torch.float32)
            new_mu.append(mu)
            new_nu.append(nu)
            new_p.append((p.to(torch.float32) - lr32 * upd).to(p.dtype))
        return (treedef.unflatten(new_p),
                OptState(step, treedef.unflatten(new_mu),
                         treedef.unflatten(new_nu)))

    return Optimizer(init, update)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    # f32 accumulation of the squares (formed at the grads' own dtype)
    norm = torch.sqrt(sum((g * g).sum(dtype=torch.float32)
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u, params, updates)
