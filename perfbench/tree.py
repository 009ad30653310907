"""Leaves of a nested dict / list / tuple of tensors, by path.

The benchmark's own walk: dict keys sorted, lists and tuples in order, a
path such as ``stages/1/0/conv1``.  The output check names each leaf by its
path on both sides, so the program's state and the reference's are
compared leaf by leaf whatever order either keeps them in.
"""
from __future__ import annotations


def leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(path, leaf), ...]`` in the walk's order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def rebuild(tree, values: dict):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(t[k], f"{prefix}{k}/") for k in t}
        if isinstance(t, (list, tuple)):
            kids = [walk(v, f"{prefix}{i}/") for i, v in enumerate(t)]
            return kids if isinstance(t, list) else tuple(kids)
        return values[prefix[:-1]]
    return walk(tree, "")
