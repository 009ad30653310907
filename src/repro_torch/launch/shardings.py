"""Partition specs of params, optimizer state, caches and batches, ported
from ``repro.launch.shardings``.

Strategy (single- and multi-pod): FSDP over "data" (every matrix's input
dim) x TP over "model" (heads / ffn / vocab / experts), batch over
("pod","data").  The gossip mesh adds a "worker" axis that parameters never
use: each worker slice holds a full replica, FSDP/TP-sharded over the
remaining axes.

Every axis assignment is divisibility-checked against the mesh; a dim that
does not divide falls back to replication for that axis (``_fit``).  The
rules, paths and fallback are exactly the JAX package's.  A "sharding" here
is the ``sharding.PartitionSpec`` itself: the dry run has no devices to
place a leaf on, so there is no ``NamedSharding``; a mesh is anything with
``axis_names`` and a ``shape`` dict (``launch.mesh.AbstractMesh``).
"""
from __future__ import annotations

import re
from typing import Any, Optional

import torch

from ..core.tree import tree_flatten, tree_flatten_with_path, tree_map
from ..sharding import PartitionSpec as P

PyTree = Any

# (regex on the param path, spec by *logical* axes per trailing dims)
# 2-D default:  in-dim -> fsdp("data"), out-dim -> tp("model")
# logical axes: "fsdp" -> data (droppable for serving), "tp" -> model
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/tok$",                 ("tp", "fsdp")),      # (V, D)
    (r"head/w$",                    ("fsdp", "tp")),      # (D, V)
    (r"(wq|wk|wv|w_uq|w_uk|w_uv)$", ("fsdp", "tp")),
    (r"(wo|out_proj|w_out|w_down)$", ("tp", "fsdp")),
    (r"(w_up|w_gate)$",             ("fsdp", "tp")),
    (r"(w_in_rnn|w_in_gate|in_proj|w_a|w_x)$", ("fsdp", "tp")),
    (r"(w_dq|w_dkv)$",              ("fsdp", None)),      # latent kept whole
    (r"router$",                    ("fsdp", None)),      # (D, E) E small
    (r"conv_w$",                    (None, "tp")),        # (W, C)
    (r"mtp/proj$",                  ("fsdp", "tp")),
]
# MoE expert tensors are 3-D (E, in, out): expert-parallel over "model",
# FSDP over "data" on the in-dim.
_MOE_RULES: list[tuple[str, tuple]] = [
    (r"(moe_up|moe_gate|moe_down)$", ("expert", "fsdp", None)),
]


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return mesh.shape[name]


def _resolve(logical: Optional[str], mesh, rules: dict):
    if logical is None:
        return None
    if logical in rules:
        return rules[logical]
    # literal mesh axis names pass through ("data"/"model" in the rules above)
    return logical if logical in mesh.axis_names else None


def _fit(spec: tuple, shape: tuple, mesh, rules: dict) -> P:
    """Map logical spec -> mesh axes, dropping axes that don't divide."""
    out = []
    for logical, dim in zip(spec, shape):
        ax = _resolve(logical, mesh, rules)
        if ax is None:
            out.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= _axis_size(mesh, a)
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
    return "/".join(parts)


def _map_with_path(fn, tree: PyTree) -> PyTree:
    pairs, treedef = tree_flatten_with_path(tree)
    return treedef.unflatten([fn(_path_str(p), leaf) for p, leaf in pairs])


def param_spec(path_str: str, leaf, mesh, rules: dict) -> P:
    shape = tuple(leaf.shape)
    nd = len(shape)
    for pat, spec in _MOE_RULES:
        if re.search(pat, path_str) and nd >= 3:
            lead = nd - 3
            return _fit((None,) * lead + spec, shape, mesh, rules)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_str) and nd >= 2:
            lead = nd - 2
            return _fit((None,) * lead + spec, shape, mesh, rules)
    # norms / biases / 1-D leaves and anything unmatched: replicate
    return P()


def param_shardings(params: PyTree, mesh, rules: dict) -> PyTree:
    return _map_with_path(
        lambda path, leaf: param_spec(path, leaf, mesh, rules), params)


def stacked_param_shardings(params: PyTree, mesh, rules: dict,
                            axis: str = "worker") -> PyTree:
    """Specs of worker-stacked params: leading dim over ``axis``, the rest
    per the normal param rules (used by StackedGossipTrainer)."""
    def one(path, leaf):
        inner = torch.empty(tuple(leaf.shape[1:]), dtype=leaf.dtype,
                            device="meta")
        base = param_spec(path, inner, mesh, rules)
        lead = axis if leaf.shape[0] % mesh.shape[axis] == 0 else None
        return P(lead, *base)
    return _map_with_path(one, params)


def batch_shardings(batch: PyTree, mesh, rules: dict,
                    leading_microbatch: bool = False) -> PyTree:
    """Batch arrays: shard the batch dim over the batch axes (if divisible).
    With ``leading_microbatch`` the batch dim is dim 1 (dim 0 = microbatch
    slices, taken in turn — never sharded)."""
    def one(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        prefix = (None, "batch") if leading_microbatch else ("batch",)
        return _fit(prefix + (None,) * (len(shape) - len(prefix)), shape,
                    mesh, rules)
    return tree_map(one, batch)


# cache leaves: (B, S, KV, hd) / (B, S, rank) -> batch over data, seq over
# model; state leaves (B, H, P, N) / (B, W) -> batch over data, dim 1 over
# model; slot_pos replicated.  Leading stacked-layer axis handled by ndim.
def cache_spec(path_str: str, leaf, mesh, rules: dict) -> P:
    shape = tuple(leaf.shape)
    nd = len(shape)
    if path_str.endswith("slot_pos") or nd <= 1:
        return P()
    base_nd = nd - 1  # caches are stacked over layers (leading axis)
    if path_str.endswith("conv") and base_nd >= 3:        # (B, W-1, C)
        spec = (None, "batch", None, "heads") + (None,) * (base_nd - 3)
    elif re.search(r"(^|/)(k|v|c|k_rope|h)$", path_str) and base_nd >= 2:
        # (B, S, ...) kv caches: seq over "model"; (B, H/W, ...) states:
        # heads/width over "model" — both are dim 1 of the per-layer leaf
        spec = (None, "batch", "heads") + (None,) * (base_nd - 2)
    else:
        spec = (None, "batch") + (None,) * (base_nd - 1)
    return _fit(spec, shape, mesh, rules)


def cache_shardings(cache: PyTree, mesh, rules: dict) -> PyTree:
    return _map_with_path(
        lambda path, leaf: cache_spec(path, leaf, mesh, rules), cache)


def replicated(mesh) -> P:
    return P()


def shard_bytes(leaf: torch.Tensor, spec: P, mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``: the leaf's
    bytes divided by the size of every mesh axis that splits it (each
    sharded dim divides by construction, ``_fit``)."""
    n = leaf.numel() * leaf.element_size()
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n //= _axis_size(mesh, a)
    return n


def per_device_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Sum of ``shard_bytes`` over the tensor leaves of ``tree`` (``None``
    leaves, such as SGD's second moment, hold nothing)."""
    leaves, treedef = tree_flatten(tree)
    return sum(shard_bytes(leaf, spec, mesh)
               for leaf, spec in zip(leaves, treedef.flatten_up_to(specs))
               if leaf is not None)
