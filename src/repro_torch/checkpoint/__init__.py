"""Checkpointing."""
from .msgpack_ckpt import load_pytree, restore, save, save_pytree

__all__ = ["load_pytree", "restore", "save", "save_pytree"]
