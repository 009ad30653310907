"""The dropless expert op of a chip's share of a MoE layer: routing
tables, the grouped SwiGLU products and the gated combine, differentiable
and batched over the workers.

Every tensor has the worker axis W in front: x (W, T, D), ids / gates (W,
T, K), the held experts' w_gate / w_up (W, n, D, F) and w_down (W, n, F,
D).  A model calls the op once a layer with W = 1 from inside
``torch.func.vmap``; each op's ``vmap`` rule folds the vmapped axis into W,
so the replay's workers share one launch a product.  A CUDA tensor
launches the kernels (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``); ``backend="ref"`` forces the plain version.

With a tracer active (``analysis.tracing``) the products are a
``moe.experts`` span, the combine ``moe.combine``, the backward
``moe.experts_bwd``, and each layer call adds a ``moe`` counter (held
rows, the largest (worker, expert) group, the groups, and the forward and
backward products' FLOPs and least bytes) whose values stay on the card
until the tracer resolves.

Inside ``keep_picks()`` every route op keeps a copy of its ids, so that a
check can replay the picks a run made.
"""
from __future__ import annotations

import contextlib

import torch

from ...analysis import tracing
from .. import fold, plain, resolve_backend
from . import kernel
from .ref import combine_dense, experts_dense, moe_experts_ref, route_ref


def flops_per_row(d: int, f: int) -> float:
    """A held row's product FLOPs, forward (3 products of 2 d f) and
    backward (da, dWd, dWg and dWu, dx: 6 more)."""
    return 18.0 * d * f


def least_bytes(rows, w: int, t: int, n: int, d: int, f: int):
    """Bytes the forward and backward launches of one layer must move, f32,
    each launch's inputs read once and outputs written once: per held row
    10 d + 14 f values (x's rows, hg, hu, y, dy, dhg, dhu, dx's rows), the
    held weights 9 times (read by the three forward and the two backward
    products, the three gradients written), and the (W, T, D) output,
    its cotangent and dx once each."""
    return 4 * (rows * (10 * d + 14 * f) + 9 * w * n * d * f + 3 * w * t * d)


# the ids of each route op while ``keep_picks`` is open, else None
_kept: list | None = None


@contextlib.contextmanager
def keep_picks():
    """Yields a list that gets a copy of the ids (W, T, K) of every route
    op made inside, in order: a model's MoE layers in turn."""
    global _kept
    outer, _kept = _kept, []
    try:
        yield _kept
    finally:
        _kept = outer


def _unfold(info, outs) -> tuple:
    b = info.batch_size
    return tuple(o.reshape(b, o.shape[0] // b, *o.shape[1:]) for o in outs)


class _Route(torch.autograd.Function):
    """ids (W, T, K) -> (meta, row, pick), ``kernel.route``'s tables."""

    @staticmethod
    def forward(ids, e0, n, backend):
        if _kept is not None:
            _kept.append(ids.clone())
        if backend == "ref":
            return route_ref(ids, e0, n)
        w, t, k = ids.shape
        return kernel.route(ids.contiguous(), e0, n, w * t * min(k, n))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, ids, e0, n, backend):
        (ids,) = fold(info.batch_size, in_dims[:1], (ids,))
        return _unfold(info, _Route.forward(ids, e0, n, backend)), (0, 0, 0)


class _Experts(torch.autograd.Function):
    """out = sum over held picks of gate * expert(x); also returns the
    packed rows the backward reads (empty for the plain version)."""

    @staticmethod
    def forward(x, gates, ids, meta, row, pick, wg, wu, wd, e0, backend):
        w, t, d = x.shape
        n, f = wg.shape[1], wg.shape[-1]
        if tracing.active() is not None:
            counts = meta[:, n:]
            rows = counts.sum()
            tracing.count_device(
                "moe", rows=rows, largest=counts.max(), groups=w * n,
                flops=rows * flops_per_row(d, f),
                bytes=least_bytes(rows, w, t, n, d, f))
        if backend == "ref":
            with torch.no_grad():
                with tracing.span("moe.experts"):
                    y = experts_dense(x, wg, wu, wd)
                with tracing.span("moe.combine"):
                    out = combine_dense(y, ids, gates, e0)
            empty = x.new_empty((w, 0))
            return out, empty, empty, empty
        x, gates = x.contiguous(), gates.contiguous()
        with tracing.span("moe.experts"):
            hg, hu, y = kernel.products(x, gates, meta, row, pick, wg, wu,
                                        wd, e0)
        with tracing.span("moe.combine"):
            out = kernel.combine(y, gates, row, t)
        return out, hg, hu, y

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gates, ids, meta, row, pick, wg, wu, wd, e0, backend = inputs
        _, hg, hu, y = output
        ctx.mark_non_differentiable(hg, hu, y)
        ctx.save_for_backward(x, gates, ids, meta, row, pick, wg, wu, wd,
                              hg, hu, y)
        ctx.e0, ctx.backend = e0, backend

    @staticmethod
    def backward(ctx, dout, *_):
        dx, dgates, dwg, dwu, dwd = _ExpertsBackward.apply(
            dout, *ctx.saved_tensors, ctx.e0, ctx.backend)
        return (dx, dgates, None, None, None, None, dwg, dwu, dwd, None,
                None)

    @staticmethod
    def vmap(info, in_dims, *args):
        # applied again to the folded tensors, so that plain autograd over
        # a vmapped forward records it (``kernels.plain``)
        outs = plain(_Experts.apply, *fold(info.batch_size, in_dims, args))
        return _unfold(info, outs), (0, 0, 0, 0)


class _ExpertsBackward(torch.autograd.Function):
    """(dx, dgates, dwg, dwu, dwd) of ``_Experts``; not differentiable
    again."""

    @staticmethod
    def forward(dout, x, gates, ids, meta, row, pick, wg, wu, wd, hg, hu, y,
                e0, backend):
        with tracing.span("moe.experts_bwd"):
            if backend == "ref":
                with torch.enable_grad():
                    ins = [a.detach().requires_grad_()
                           for a in (x, gates, wg, wu, wd)]
                    out = moe_experts_ref(ins[0], ids, ins[1], *ins[2:], e0)
                    grads = torch.autograd.grad(out, ins, dout)
                return tuple(g.detach() for g in grads)
            return kernel.backward(dout.contiguous(), x.contiguous(),
                                   gates.contiguous(), meta, row, pick, wg,
                                   wu, wd, hg, hu, y, e0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the expert kernels have no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _ExpertsBackward.forward(*fold(info.batch_size, in_dims, args))
        return _unfold(info, outs), (0,) * 5


def moe_route(ids: torch.Tensor, e0: int, n: int, *, backend: str = "auto"
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing tables of ids (W, T, K) for held experts e0 .. e0 + n -
    1: (meta (W, 2n), row (W, T, K), pick (W, T * min(K, n)))."""
    return _Route.apply(ids, e0, n, resolve_backend(backend, ids))


def moe_experts(x: torch.Tensor, gates: torch.Tensor, ids: torch.Tensor,
                routing: tuple, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, e0: int, *, backend: str = "auto"
                ) -> torch.Tensor:
    """(W, T, D): every held pick's SwiGLU expert, weighted by its gate,
    summed a token; ``routing`` is ``moe_route(ids, e0, n)``."""
    return _Experts.apply(x, gates, ids, *routing, w_gate, w_up, w_down, e0,
                          resolve_backend(backend, x))[0]
