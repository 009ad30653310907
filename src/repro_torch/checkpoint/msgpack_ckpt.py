"""Msgpack pytree checkpointing with atomic writes and step retention,
ported from ``repro.checkpoint.msgpack_ckpt``.

The file format is the JAX package's: one MessagePack map

    {"treedef": str, "leaves": [{"__np__": True, "dtype": str,
                                 "shape": [...], "data": bytes}, ...]}

with the leaves in the JAX package's order (dict keys sorted, lists and
tuples in position order, ``None`` holding no leaf), so a checkpoint
written by either package loads into the other.  Both loaders ignore
``treedef``: the port writes its own description of the structure there.
bfloat16 leaves are stored as the dtype string ``"bfloat16"`` and their
raw 2-byte words.  The MessagePack bytes come from the port's own codec
(``msgpack_codec``), which writes what ``msgpack.packb(payload,
use_bin_type=True)`` writes.

Tensors are copied to the host before serialization; a loaded leaf goes
to the device and dtype of the matching leaf of ``like``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from .msgpack_codec import packb, unpackb

PyTree = Any

_DTYPE_KEY = "__np__"


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _leaves(tree: PyTree, out: list) -> list:
    """The leaves in the JAX package's order; ``None`` holds none."""
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    else:
        out.append(tree)
    return out


def _rebuild(like: PyTree, it) -> PyTree:
    """A tree shaped as ``like`` (its dict, list, tuple and named-tuple
    types) filled from ``it`` in ``_leaves`` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        kids = [_rebuild(t, it) for t in like]
        if _is_namedtuple(like):
            return type(like)(*kids)
        return type(like)(kids)
    return next(it)


def _describe(tree: PyTree) -> str:
    """A readable description of the structure (``*`` a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + "".join(_describe(t) + ", " for t in tree) + ")"
    return "*"


def _pack_leaf(x) -> dict:
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the raw 2-byte words
            return {_DTYPE_KEY: True, "dtype": "bfloat16",
                    "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return {_DTYPE_KEY: True, "dtype": str(arr.dtype),
            "shape": list(arr.shape), "data": arr.tobytes()}


def _unpack_leaf(d: dict) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        words = np.frombuffer(d["data"], dtype=np.int16).copy()
        return torch.from_numpy(words.reshape(d["shape"])).view(
            torch.bfloat16)
    arr = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).copy()
    return torch.from_numpy(arr.reshape(d["shape"]))


def save_pytree(path: str, tree: PyTree) -> None:
    """Write ``tree`` to ``path`` atomically (a temporary file in the
    target directory, then ``os.replace``)."""
    payload = {"treedef": _describe(tree),
               "leaves": [_pack_leaf(leaf) for leaf in _leaves(tree, [])]}
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(packb(payload))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (leaf count and shapes
    checked); each leaf takes the device and dtype of ``like``'s."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    refs = _leaves(like, [])
    stored = payload["leaves"]
    if len(stored) != len(refs):
        raise ValueError(f"checkpoint has {len(stored)} leaves, "
                         f"expected {len(refs)}")
    out = []
    for ref, d in zip(refs, stored):
        t = _unpack_leaf(d)
        if tuple(t.shape) != tuple(np.shape(ref)):
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs "
                             f"{tuple(np.shape(ref))}")
        if torch.is_tensor(ref):
            t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t)
    return _rebuild(like, iter(out))


def save(ckpt_dir: str, step: int, state: PyTree, keep: int = 3) -> str:
    """Save ``state`` under ckpt_dir/step_<n>/state.msgpack and keep the
    last ``keep`` steps."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.msgpack")
    save_pytree(path, state)
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    return path


def restore(ckpt_dir: str, like: PyTree, step: int | None = None
            ) -> tuple[int, PyTree]:
    """(step, state) of the latest checkpoint in ``ckpt_dir`` (or of
    ``step``), loaded into the structure of ``like``."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    chosen = f"step_{step:08d}" if step is not None else steps[-1]
    n = int(chosen.split("_")[1])
    return n, load_pytree(os.path.join(ckpt_dir, chosen, "state.msgpack"),
                          like)
