"""Logical-axis partition rules, ported from ``repro.sharding``.

The dry run (``launch/dryrun.py``) names the axes of every parameter,
cache and batch leaf by *logical* names, and a rule table maps each
logical name to mesh axes:

  batch   — data-parallel batch dim          -> ("pod","data") or ("data",)
  seq     — sequence                          -> "model"
  heads   — attention heads / kv heads        -> "model"
  ffn     — mlp hidden                        -> "model"
  vocab   — vocabulary                        -> "model"
  expert  — MoE expert axis                   -> "model"
  fsdp    — parameter FSDP shard axis         -> "data"
  tp      — parameter tensor-parallel axis    -> "model"

The tables are exactly the JAX package's.  Its ``hint``, ``hint_any``,
``use_mesh`` and ``forward_only`` are not here: they steer XLA's SPMD
partitioner from inside the model code, and the port's models carry no
hints (``models/layers.py``, ``models/attention.py``) and have no
partitioner to steer.  The specs here feed the dry run's per-device
accounting only.
"""
from __future__ import annotations

from typing import Any, Optional


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: one entry per leading dimension,
    each a mesh-axis name, a tuple of names, or ``None`` (replicated);
    missing trailing entries are replicated.  Equal to a spec or a tuple of
    the same entries.  Not itself a tuple, so that a tree of specs
    flattens to one leaf per spec (``core.tree``)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        if isinstance(other, tuple):
            return self.parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


def logical_to_spec(axes: tuple[Optional[str], ...],
                    rules: Optional[dict[str, Any]] = None) -> PartitionSpec:
    """The mesh axes of each logical name (``None`` where ``rules`` has
    none; every entry ``None`` without rules, as the JAX function gives
    with no mesh installed)."""
    rules = rules or {}
    return PartitionSpec(*[rules.get(a) if a else None for a in axes])


# Default rules for the production meshes (launch/mesh.py)
SINGLE_POD_RULES = {
    "batch": "data", "heads": "model", "ffn": "model", "vocab": "model",
    "expert": "model", "fsdp": "data", "tp": "model", "seq": "model", "act_embed": "model",
}
MULTI_POD_RULES = {
    "batch": ("pod", "data"), "heads": "model", "ffn": "model",
    "vocab": "model", "expert": "model", "fsdp": "data", "tp": "model", "seq": "model", "act_embed": "model",
}
GOSSIP_RULES = {  # worker axis never appears in model shardings
    "batch": "data", "heads": "model", "ffn": "model", "vocab": "model",
    "expert": "model", "fsdp": "data", "tp": "model", "seq": "model", "act_embed": "model",
}
REPLAY_RULES = {  # 1-D replay mesh (launch/mesh.make_replay_mesh): only
    # the flat gossip banks' worker axis is split; model-logical axes
    # have no mesh axis to land on and stay replicated
    "worker": "worker",
}
