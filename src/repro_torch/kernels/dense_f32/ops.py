"""``dense(x, w)``: a model's weight product ``x @ w``, with its f32 route
on the tensor cores.

x (..., K) against a weight w (K, N).  The rule is one look at the input:
an f32 x and w on the card, with at least ``MIN_ROWS`` rows in x's leading
axes, go through ``_Gemm``, whose forward (Y = X W) and backward (dX = dY
W^T, dW = X^T dY, the rows contracted) are each one launch of the 3xTF32
kernel (``kernel.py``); anything else (bf16, the CPU, decode's single
rows) is ``x @ w``, as the JAX package computes it.  Under ``vmap`` the
vmapped axis is folded into the kernel's batch, so a vmapped tick over
the workers launches one product for all of them, reading each worker's
slice of the stacked weight where it lies.  One fold (``_folded``,
through ``kernels.fold``) does it, reached two ways: ``_Gemm``'s ``vmap``
rule under any transform (a ``StackedGossipTrainer``'s
``vmap(grad_and_value)``), and ``gemm`` by hand under one ``vmap`` alone
(``lm_grad_fn``'s forward, differentiated by plain autograd), where the
transform's Python around an ``autograd.Function`` would cost more host
time than the kernel saves device time.  Backward saves x and w, as
``matmul``'s autograd does, and writes each gradient in its input's
layout (a transposed weight, the tied head's ``tok.T``, gets a transposed
gradient).  On the card every product launches the kernel: a layout it
cannot read (no axis at stride 1, strides off 16 bytes) raises there, as
``gemm_3xtf32`` does; the plain version serves CPU tensors alone.

With a tracer active (``analysis.tracing``) every product adds a
``dense`` counter sample: the products and FLOPs that ran on the kernel
(``kernel_products``, ``kernel_flops``) and on ``matmul``
(``matmul_products``, ``matmul_flops``; a differentiated ``x @ w`` counts
its two backward products with its forward).
"""
from __future__ import annotations

import math

import torch
from torch._C._functorch import (TransformType, _add_batch_dim,
                                 _unwrap_batched, get_interpreter_stack,
                                 get_unwrapped, is_batchedtensor,
                                 is_functorch_wrapped_tensor,
                                 maybe_get_level)

from ...analysis import tracing
from .. import fold, plain
from .kernel import gemm_3xtf32, operand_layout
from .ref import gemm_ref

# fewer rows than one wgmma's 64 leave the tensor cores mostly idle
MIN_ROWS = 64


def on_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """The dispatch rule: f32 x and w on the card, x with at least
    ``MIN_ROWS`` rows."""
    return (x.dtype == torch.float32 and w.dtype == torch.float32
            and x.is_cuda and w.dim() == 2
            and math.prod(x.shape[:-1]) >= MIN_ROWS)


def _physical(t: torch.Tensor) -> torch.Tensor:
    """t with every functorch wrapper (vmap, grad) taken off."""
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t


def _count(kernel: bool, products: int, flops: float) -> None:
    if tracing.active() is not None:
        on, off = (products, flops) if kernel else (0, 0.0)
        tracing.count_device(
            "dense", kernel_products=on, kernel_flops=off,
            matmul_products=products - on, matmul_flops=flops - off)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (batch, M, K) @ b (batch, K, N) on plain tensors: the kernel on
    the card, the plain version on the CPU."""
    _count(a.is_cuda, 1, 2.0 * a.shape[0] * a.shape[1] * a.shape[2]
           * b.shape[2])
    return gemm_3xtf32(a, b) if a.is_cuda else gemm_ref(a, b)


def _in_layout_of(t: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """x @ y (batched), laid out as t: where t is column-major (a
    transposed weight), computed as (y^T x^T)^T."""
    if t.stride(-2) == 1 and t.stride(-1) != 1:
        return _Gemm.apply(y.transpose(1, 2), x.transpose(1, 2)) \
            .transpose(1, 2)
    return _Gemm.apply(x, y)


class _Gemm(torch.autograd.Function):
    """(batch, M, K) @ (batch, K, N), differentiable and vmappable.  Its
    ``vmap`` rule applies it again to the folded plain tensors with the
    transforms' stack set aside (``plain``), so that where plain autograd
    records the vmapped forward (``lm_grad_fn``) the node lies on the plain
    tensors and the backward runs on them, outside any transform."""

    @staticmethod
    def forward(a, b):
        return _product(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _in_layout_of(a, dc, b.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            db = _in_layout_of(b, a.transpose(1, 2), dc)
        return da, db

    @staticmethod
    def vmap(info, in_dims, a, b):
        return _folded(info.batch_size, in_dims, a, b), 0


def _folded(size: int, in_dims, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """``_Gemm`` of the plain tensors a, b, vmapped over ``size`` on the
    axes ``in_dims`` (None: unbatched), as one product of the folded
    batch, outside the transforms (``plain``): (size, batch, M, N)."""
    c = plain(_Gemm.apply, *fold(size, in_dims, (a, b)))
    return c.reshape(size, -1, *c.shape[1:])


def _one_vmap_level(*ts) -> int | None:
    """The level of the one transform active, where it is a ``vmap`` and
    ``ts`` are plain or batched at it, one of them batched; else None."""
    stack = get_interpreter_stack()
    if stack is None or len(stack) != 1 \
            or stack[0].key() != TransformType.Vmap:
        return None
    level, batched = stack[0].level(), False
    for t in ts:
        if is_functorch_wrapped_tensor(t):
            if not (is_batchedtensor(t) and maybe_get_level(t) == level):
                return None
            batched = True
    return level if batched else None


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) through ``_Gemm`` whatever the device: the
    kernel on the card, the plain version on the CPU.  Under one ``vmap``
    alone (``lm_grad_fn``'s forward) the batched tensors are unwrapped
    here and folded as ``_Gemm``'s ``vmap`` rule folds them, without the
    transform's own Python around a function call."""
    k, n = x.shape[-1], w.shape[-1]
    level = _one_vmap_level(x, w)
    if level is None:
        y = _Gemm.apply(x.reshape(1, -1, k), w[None])
        return y.reshape(*x.shape[:-1], n)
    (xp, xd), (wp, wd) = _unwrap_batched(x, level), _unwrap_batched(w, level)
    size = xp.shape[xd] if xd is not None else wp.shape[wd]
    # each operand as the one-matrix batch _Gemm takes, the vmapped axis
    # first
    a = xp.reshape(1, -1, k) if xd is None \
        else xp.movedim(xd, 0).reshape(size, 1, -1, k)
    b = wp[None] if wd is None else wp.movedim(wd, 0)[:, None]
    y = _folded(size, (None if xd is None else 0, None if wd is None else 0),
                a, b)
    return _add_batch_dim(y.reshape(size, *x.shape[:-1], n), 0, level)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N): ``gemm`` where ``on_kernel`` holds, else
    ``x @ w``."""
    if on_kernel(x, w):
        return gemm(x, w)
    if tracing.active() is not None:
        px, pw = _physical(x), _physical(w)
        batch = max(px.numel() // max(x.numel(), 1),
                    pw.numel() // max(w.numel(), 1))
        products = 3 if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad) else 1
        _count(False, products, products * 2.0 * batch * x.numel()
               * w.shape[-1])
    return x @ w
