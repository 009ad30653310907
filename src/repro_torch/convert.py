"""Carry parameter trees, decode caches and trainer states between the JAX
package and the port.

The JAX side hands its tree over as numpy arrays (``jax.device_get``); this
module never imports JAX.  Structure, shapes and dtypes are kept: dicts stay
dicts, tuples stay tuples, lists stay lists, bfloat16 stays bfloat16.  A
trainer state's named fields (``OptState``, ``DelayRing``, the trainer
states) are read by name; a JAX PRNG key has no torch counterpart, so the
caller names the generator of the carried state.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tree import PyTree, tree_map
from .device import resolve_device


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy the tensor may own
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX returns it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree: PyTree, device="cuda") -> PyTree:
    """JAX parameter pytree (numpy leaves) -> the port's tree of tensors on
    ``device`` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), np_tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, the dtype JAX hands out
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: PyTree) -> PyTree:
    """The port's tree of tensors -> numpy leaves (the inverse of
    ``params_from_jax``; bfloat16 leaves need the ``ml_dtypes`` package)."""
    return tree_map(_to_numpy, tree)


def caches_from_jax(np_caches, device="cuda") -> list:
    """JAX decode caches (``Model.init_cache``'s list of per-group
    ``{"b{i}": {"k", "v", "slot_pos"}}``, numpy leaves) -> the port's, on
    ``device``; ``slot_pos`` stays int32."""
    return params_from_jax(np_caches, device)


def caches_to_numpy(caches: list) -> list:
    """The port's decode caches -> numpy leaves (the inverse of
    ``caches_from_jax``)."""
    return params_to_numpy(caches)


def opt_state_from_jax(np_opt, device="cuda"):
    """A JAX ``OptState`` (numpy leaves) -> the port's ``OptState``."""
    from .optim import OptState
    dev = resolve_device(device)
    return OptState(_to_tensor(np_opt.step, dev),
                    params_from_jax(np_opt.mu, dev),
                    None if np_opt.nu is None
                    else params_from_jax(np_opt.nu, dev))


def train_state_from_jax(np_state, device="cuda"):
    """A JAX ``launch.steps.TrainState`` (numpy leaves: the params and the
    ``OptState``) -> the port's ``TrainState``."""
    from .launch.steps import TrainState
    dev = resolve_device(device)
    return TrainState(params_from_jax(np_state.params, dev),
                      opt_state_from_jax(np_state.opt, dev))


def _ring_from_jax(np_ring, dev):
    from .core.gossip import DelayRing
    if np_ring is None:
        return None
    return DelayRing(_to_tensor(np_ring.buf, dev),
                     _to_tensor(np_ring.round, torch.device("cpu")))


def gossip_state_from_jax(np_state, generator: torch.Generator,
                          device="cuda"):
    """A JAX ``GossipTrainState`` in its global view (every per-worker leaf
    with a leading worker axis, as a ``shard_map``ped or ``jax.vmap``ped
    step holds it) -> the port's per-worker ``GossipTrainState``."""
    from .launch.gossip_train import GossipTrainState, unstack_workers
    dev = resolve_device(device)
    return unstack_workers(GossipTrainState(
        params_from_jax(np_state.params, dev),
        params_from_jax(np_state.momentum, dev),
        opt_state_from_jax(np_state.opt, dev),
        _to_tensor(np_state.t_last, dev), generator,
        _ring_from_jax(np_state.ring, dev)))


def stacked_state_from_jax(np_state, generator: torch.Generator,
                           device="cuda"):
    """A JAX ``StackedGossipState`` (numpy leaves) -> the port's."""
    from .launch.gossip_train import StackedGossipState
    dev = resolve_device(device)
    ring = _ring_from_jax(np_state.ring, dev)
    if ring is not None:
        ring = ring._replace(round=int(ring.round))
    return StackedGossipState(params_from_jax(np_state.x, dev),
                              params_from_jax(np_state.x_tilde, dev),
                              opt_state_from_jax(np_state.opt, dev),
                              generator, ring)
