"""Minimal pytrees over dicts, lists and tuples of tensors.

Leaves are visited in the order ``jax.tree_util`` visits them: dict keys in
SORTED order, lists and tuples in position order.  ``torch.utils._pytree``
visits dict keys in insertion order instead, which would put the ResNet
tree's leaves in another order and shift every offset of the flat buffer;
with this module a packed buffer of the port equals the JAX package's
column for column.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Structure of a pytree: ``kind`` is "leaf", "dict", "list" or
    "tuple"; ``keys`` are the sorted dict keys; ``children`` the subtrees."""

    kind: str
    keys: tuple = ()
    children: tuple["TreeDef", ...] = ()

    def unflatten(self, leaves) -> PyTree:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("too many leaves for this tree structure")
        return out

    def _build(self, it) -> PyTree:
        if self.kind == "leaf":
            try:
                return next(it)
            except StopIteration:
                raise ValueError("too few leaves for this tree structure") \
                    from None
        kids = []
        for c in self.children:  # leaves inline: no call a leaf
            kid = next(it, _END) if c.kind == "leaf" else c._build(it)
            if kid is _END:
                raise ValueError("too few leaves for this tree structure")
            kids.append(kid)
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return kids if self.kind == "list" else tuple(kids)

    def flatten_up_to(self, tree: PyTree) -> list:
        """Leaves of ``tree`` at this structure's leaf positions (a leaf
        position may hold a whole subtree, as in ``jax.tree_util``)."""
        out: list = []
        self._collect(tree, out)
        return out

    def _collect(self, tree, out: list) -> None:
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or tuple(sorted(tree)) != self.keys:
                raise ValueError(f"expected a dict with keys {self.keys}")
            for k, c in zip(self.keys, self.children):
                if c.kind == "leaf":
                    out.append(tree[k])
                else:
                    c._collect(tree[k], out)
            return
        want = list if self.kind == "list" else tuple
        if not isinstance(tree, want) or len(tree) != len(self.children):
            raise ValueError(f"expected a {self.kind} of length "
                             f"{len(self.children)}")
        for sub, c in zip(tree, self.children):
            if c.kind == "leaf":
                out.append(sub)
            else:
                c._collect(sub, out)


_END = object()
_LEAF = TreeDef("leaf")


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    """(leaves, treedef) with dict keys visited in sorted order."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _flatten(tree, leaves: list) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys,
                       _children([tree[k] for k in keys], leaves))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, (), _children(tree, leaves))
    leaves.append(tree)
    return _LEAF


def _children(subtrees, leaves: list) -> tuple:
    """The structures of ``subtrees``, their leaves appended to ``leaves``
    inline (no call a leaf)."""
    out = []
    for t in subtrees:
        if isinstance(t, (dict, list, tuple)):
            out.append(_flatten(t, leaves))
        else:
            leaves.append(t)
            out.append(_LEAF)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class DictKey:
    """A dict entry on a leaf's path (``jax.tree_util.DictKey``)."""

    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    """A list or tuple position on a leaf's path
    (``jax.tree_util.SequenceKey``)."""

    idx: int


def tree_flatten_with_path(tree: PyTree) -> tuple[list, TreeDef]:
    """([(path, leaf), ...], treedef) in ``tree_flatten``'s leaf order, each
    path a tuple of ``DictKey`` / ``SequenceKey`` from the root, as
    ``jax.tree_util.tree_flatten_with_path`` gives it."""
    leaves, treedef = tree_flatten(tree)
    paths: list = []
    _paths(tree, (), paths)
    return list(zip(paths, leaves)), treedef


def _paths(tree, prefix: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], prefix + (DictKey(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _paths(t, prefix + (SequenceKey(i),), out)
    else:
        out.append(prefix)


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over ``tree`` and trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])
