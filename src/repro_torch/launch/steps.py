"""Step functions, ported from ``repro.launch.steps``: the synchronous train
step, the prefill step and the serve (decode) step, and their assembly for
the dry run (``bundle_for``).

The JAX package's steps are jit-able functions with sharding hints; here
they are plain functions on tensors.  ``forward_only()`` becomes
``torch.no_grad()``, which keeps no graph (and lets the flash kernel, which
has no backward, run).  The dry run's ``ShapeDtypeStruct``s are tensors on
the meta device, and its ``.lower().compile()`` is ``LoweredSpec.trace``:
the step run once on those tensors under the op counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..analysis.op_cost import OpCost, count
from ..core.tree import PyTree, tree_flatten, tree_leaves, tree_map
from ..models.config import ModelConfig
from ..models.layers import SHAPE_ONLY
from ..models.transformer import Model
from ..optim import clip_by_global_norm, sgd
from ..optim.optimizers import Optimizer, OptState
from ..shapes import (META, InputShape, adapt_config, decode_input_specs,
                      train_input_specs)
from . import shardings as S
from .mesh import mesh_devices


class TrainState(NamedTuple):
    params: PyTree
    opt: OptState


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """Everything needed to run one (arch x shape) step."""

    fn: Callable                      # the step function
    in_shardings: tuple
    state_specs: PyTree | None        # meta tensors of carried state
    donate_argnums: tuple = ()


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


# -------------------------------------------------------- dry-run assembly

def abstract_params(model: Model) -> PyTree:
    """``model.init``'s tree on the meta device: shapes and dtypes, no
    draws, no storage."""
    return model.init(SHAPE_ONLY)


def abstract_train_state(model: Model, optimizer: Optimizer) -> TrainState:
    params = abstract_params(model)
    return TrainState(params, optimizer.init(params))


def _microbatched(leaf: torch.Tensor, m: int) -> torch.Tensor:
    return torch.empty((m, leaf.shape[0] // m) + tuple(leaf.shape[1:]),
                       dtype=leaf.dtype, device=META)


def bundle_for(cfg: ModelConfig, shape: InputShape, mesh, rules,
               train_microbatches: int = 4,
               serve_param_mode: str = "fsdp") -> "LoweredSpec":
    """The step, its meta arguments and their partition specs for one arch
    x shape on a mesh.

    Train: ``make_train_step`` with ``train_microbatches`` micro-batches
    (the batch leaves get a leading micro-batch axis) and remat; prefill:
    the forward of the inputs only, under ``no_grad``; decode: one token
    against the caches.  serve_param_mode: "fsdp" shards serve params over
    data+model (memory-optimal, but gathers the weights layer by layer
    every decoded token); "tp_only" replicates them over data (TP-sharded
    only)."""
    cfg = adapt_config(cfg, shape)
    model = Model(cfg)

    if shape.kind == "train":
        m = train_microbatches
        train_step, optimizer = make_train_step(model, num_microbatches=m)
        state = abstract_train_state(model, optimizer)
        batch = train_input_specs(cfg, shape)
        if m > 1:
            batch = tree_map(lambda t: _microbatched(t, m), batch)
        state_sh = TrainState(
            S.param_shardings(state.params, mesh, rules),
            OptState(S.replicated(mesh),
                     S.param_shardings(state.opt.mu, mesh, rules),
                     None if state.opt.nu is None else
                     S.param_shardings(state.opt.nu, mesh, rules)))
        batch_sh = S.batch_shardings(batch, mesh, rules,
                                     leading_microbatch=(m > 1))
        return LoweredSpec(train_step, (state, batch),
                           (state_sh, batch_sh), donate=(0,))

    params = abstract_params(model)
    serve_rules = dict(rules)
    if serve_param_mode == "tp_only":
        serve_rules["fsdp"] = None
    params_sh = S.param_shardings(params, mesh, serve_rules)
    if shape.kind == "prefill":
        fn = make_prefill_step(model)
        batch = {"inputs": train_input_specs(cfg, shape)["inputs"]}
        return LoweredSpec(fn, (params, batch),
                           (params_sh, S.batch_shardings(batch, mesh, rules)),
                           donate=())

    # decode
    fn = make_serve_step(model)
    dspecs = decode_input_specs(cfg, shape)
    caches = model.init_cache(shape.global_batch, shape.seq_len, device=META)
    caches_sh = S.cache_shardings(caches, mesh, rules)
    inputs_sh = S.batch_shardings({"inputs": dspecs["inputs"]}, mesh,
                                  rules)["inputs"]
    return LoweredSpec(
        fn, (params, caches, dspecs["inputs"], dspecs["pos"]),
        (params_sh, caches_sh, inputs_sh, S.replicated(mesh)), donate=(1,))


@dataclasses.dataclass(frozen=True)
class LoweredSpec:
    """A step, its meta arguments, their partition specs and the arguments
    the step consumes (``donate``; the JAX package donates them to XLA,
    the port's steps return fresh state and leave them to the caller)."""

    fn: Callable
    args: tuple                 # meta-tensor pytrees
    arg_shardings: tuple        # sharding.PartitionSpec pytrees
    donate: tuple

    def trace(self, mesh=None) -> OpCost:
        """Run the step once on its meta arguments under the op counter
        (``analysis.op_cost``): the counterpart of JAX's
        ``.lower(...).compile()`` and its cost and memory analyses.
        Nothing is computed or allocated.  ``flops``, ``write_bytes`` and
        ``collective_*`` are the whole program's, divided evenly over the
        devices of ``mesh`` when one is given; ``peak_live_bytes`` is the
        peak of the storages the step makes (its arguments not included),
        never divided."""
        _, cost = count(self.fn, *self.args)
        if mesh is None:
            return cost
        n = mesh_devices(mesh)
        return dataclasses.replace(
            cost, flops=cost.flops / n, write_bytes=cost.write_bytes / n,
            collective_bytes=cost.collective_bytes / n,
            collective_detail={k: v / n
                               for k, v in cost.collective_detail.items()})

    def arg_bytes(self, mesh) -> int:
        """One device's bytes of the arguments: each leaf's bytes divided
        by the sizes of the mesh axes that shard it (exact)."""
        return sum(S.per_device_bytes(a, sh, mesh)
                   for a, sh in zip(self.args, self.arg_shardings))
