"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper reports a launch's work to ``analysis.op_cost.record`` (the
FLOPs its plain version's aten ops would count, and the bytes the kernel
must move), since a dispatch mode cannot see a kernel bound through
``ctypes``."""
from __future__ import annotations

import torch


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for a CUDA tensor, 'ref' for a CPU tensor; 'ref'
    passes through.  A CUDA tensor never falls back to the plain version:
    its kernel launches or raises."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    if backend != "ref":
        raise ValueError(f"unknown backend {backend!r}, have 'auto', 'ref'")
    return backend
