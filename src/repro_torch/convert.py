"""Carry parameter trees between the JAX package and the port.

The JAX side hands its tree over as numpy arrays (``jax.device_get``); this
module never imports JAX.  Structure, shapes and dtypes are kept: dicts stay
dicts, tuples stay tuples, lists stay lists, bfloat16 stays bfloat16.
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
