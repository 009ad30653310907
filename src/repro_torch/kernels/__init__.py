"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper reports a launch's work to ``analysis.op_cost.record`` (the
FLOPs its plain version's aten ops would count, and the bytes the kernel
must move), since a dispatch mode cannot see a kernel bound through
``ctypes``."""
from __future__ import annotations

import torch
from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for a CUDA tensor, 'ref' for a CPU tensor; 'ref'
    passes through.  A CUDA tensor never falls back to the plain version:
    its kernel launches or raises."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    if backend != "ref":
        raise ValueError(f"unknown backend {backend!r}, have 'auto', 'ref'")
    return backend


def fold(size: int, in_dims, args) -> list:
    """An op's ``vmap`` rule's inputs as one batch: each tensor of ``args``
    with the vmapped axis (``size`` long, at its entry of ``in_dims``)
    merged into its leading axis, an unbatched one broadcast along it;
    anything else as it is."""
    out = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = a.expand(size, *a.shape) if d is None else a.movedim(d, 0)
            a = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
        out.append(a)
    return out


def plain(fn, *args):
    """``fn(*args)`` with the ``torch.func`` transforms' stack set aside:
    an op's ``vmap`` rule applies its ``autograd.Function`` to the folded
    plain tensors this way, so that plain autograd records it where it
    records the vmapped forward (``models.transformer.lm_grad_fn``)."""
    with temporarily_clear_interpreter_stack():
        return fn(*args)
