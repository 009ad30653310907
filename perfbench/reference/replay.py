"""Algorithm 1 of the A2CiD2 paper (arXiv:2306.08289), event by event.

Every worker holds x and x~.  Between its events a worker follows the
mixing flow exp(t A): with c = (1 - exp(-2 eta t)) / 2, x += c (x~ - x) and
x~ -= c (x~ - x).  At an averaging event on edge (i, j) both mix up to the
event's time, then with m = x_i - x_j: x_i -= alpha m, x~_i -= alpha~ m,
and j the same with -m.  At its gradient time a worker mixes up to it and
takes the step x -= gamma g, x~ -= gamma g, with g the gradient of its own
batch at its x.  eta, alpha and alpha~ come from the graph by Prop 3.6.

The workers' state is a (W, D) float32 table in the order of
``perfbench.tree.leaves``; each worker's gradient is one plain autograd
pass over that worker's batch.  ``fault`` plants a known fault in the
reference (``half_batch``: each worker's batch cut to its first half;
``no_exchange``: no averaging at events), which is how the benchmark
reads what a broken program would.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import tree


def prop36(edges, rate: float, n: int, accelerated: bool
           ) -> tuple[float, float, float]:
    """(eta, alpha, alpha~) of the graph: chi_1 = 1 / lambda_2 of the
    expected Laplacian, chi_2 = max over edges of half the effective
    resistance; A2CiD2 takes eta = 1 / (2 sqrt(chi_1 chi_2)), alpha = 1/2,
    alpha~ = sqrt(chi_1 / chi_2) / 2; the baseline eta = 0, 1/2, 1/2."""
    if not accelerated:
        return 0.0, 0.5, 0.5
    lap = np.zeros((n, n))
    for i, j in edges:
        lap[i, i] += rate
        lap[j, j] += rate
        lap[i, j] -= rate
        lap[j, i] -= rate
    chi1 = 1.0 / np.linalg.eigvalsh(lap)[1]
    pinv = np.linalg.pinv(lap)
    chi2 = 0.5 * max(pinv[i, i] + pinv[j, j] - 2 * pinv[i, j]
                     for i, j in edges)
    return (1.0 / (2.0 * math.sqrt(chi1 * chi2)), 0.5,
            0.5 * math.sqrt(chi1 / chi2))


@contextlib.contextmanager
def precision(name: str):
    """``f32``: TF32 off, as the configurations state.  ``tf32``: the
    products on the TF32 tensor cores, the control's lower precision."""
    on = name == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def halve(v: torch.Tensor) -> torch.Tensor:
    """The first half of one worker's batch: of its rows, or of its one
    sequence's positions."""
    return v[:v.shape[0] // 2] if v.shape[0] > 1 else v[:, :v.shape[1] // 2]


def _norms(x: torch.Tensor, spans) -> dict[str, np.ndarray]:
    """{path: (W,) float64 L2 norms} of the rows of each leaf's columns."""
    return {p: torch.linalg.vector_norm(x[:, a:b].double(), dim=1)
            .cpu().numpy() for p, a, b in spans}


def replay(x0, arrays: dict, dyn: tuple[float, float, float], gamma: float,
           loss_fn, batch_fn, prec: str = "f32", fault: str | None = None
           ) -> dict:
    """Replay the rounds of ``arrays`` (``streams.schedule.sample``) from
    every worker at ``x0``.  ``loss_fn(params, batch_row)`` is one
    worker's loss, ``batch_fn(tick)`` the tick's (W, ...) batch.  Returns
    ``loss`` (R,) mean worker losses, ``grad`` {path: (W,)} the norms of
    the first gradient, ``change_x`` / ``change_xt`` {path: (W,)} the
    norms of each buffer's change from ``x0`` after the last round,
    ``resolution`` {path: float} the norm of each leaf's float32 spacing
    at ``x0`` over gamma, which bounds how finely its state shows a step,
    and ``size`` {path: elements}."""
    eta, alpha, alpha_t = dyn
    named = tree.leaves(x0)
    spans, off = [], 0
    for path, leaf in named:
        spans.append((path, off, off + leaf.numel()))
        off += leaf.numel()
    n = arrays["partners"].shape[2]
    flat0 = torch.cat([leaf.reshape(-1) for _, leaf in named]).float()
    x = flat0.expand(n, -1).clone()
    xt = x.clone()
    t_last = np.zeros(n)

    def mix(i: int, t: float) -> None:
        if eta > 0.0:
            c = 0.5 * (1.0 - math.exp(-2.0 * eta * (t - t_last[i])))
            d = xt[i] - x[i]
            x[i].add_(d, alpha=c)
            xt[i].sub_(d, alpha=c)
        t_last[i] = t

    def grad(i: int, batch: dict) -> tuple[float, torch.Tensor]:
        leaves = {p: x[i, a:b].view(leaf.shape).detach().requires_grad_()
                  for (p, a, b), (_, leaf) in zip(spans, named)}
        row = {k: v[i] for k, v in batch.items()}
        if fault == "half_batch":
            row = {k: halve(v) for k, v in row.items()}
        value = loss_fn(tree.rebuild(x0, leaves), row)
        # a leaf the model never reads (the stem's GroupNorm) gets 0
        gs = torch.autograd.grad(value, list(leaves.values()),
                                 allow_unused=True, materialize_grads=True)
        return float(value.detach()), torch.cat([g.reshape(-1) for g in gs])

    mag = flat0.abs()
    spacing = torch.nextafter(mag, torch.tensor(math.inf,
                                                device=mag.device)) - mag
    del mag
    out = {"loss": [], "size": {p: b - a for p, a, b in spans},
           "resolution": {
               p: float(torch.linalg.vector_norm(spacing[a:b].double()))
               / gamma for p, a, b in spans}}
    del spacing
    with precision(prec):
        for r in range(arrays["partners"].shape[0]):
            for e in range(arrays["partners"].shape[1]):
                if not arrays["event_mask"][r, e]:
                    continue
                p = arrays["partners"][r, e]
                t = float(arrays["event_times"][r, e])
                for i in range(n):
                    if p[i] != i:
                        mix(i, t)
                if fault == "no_exchange":
                    continue
                for i in range(n):
                    j = int(p[i])
                    if i < j:
                        m = x[i] - x[j]
                        x[i].sub_(m, alpha=alpha)
                        x[j].add_(m, alpha=alpha)
                        xt[i].sub_(m, alpha=alpha_t)
                        xt[j].add_(m, alpha=alpha_t)
            batch = batch_fn(r)
            losses, gs = [], []
            for i in range(n):
                mix(i, float(arrays["grad_times"][r, i]))
                value, g = grad(i, batch)
                losses.append(value)
                gs.append(g)
            for i in range(n):
                x[i].sub_(gs[i], alpha=gamma)
                xt[i].sub_(gs[i], alpha=gamma)
            if r == 0:
                out["grad"] = _norms(torch.stack(gs), spans)
            del gs
            out["loss"].append(float(np.mean(losses)))
    out["change_x"] = _norms(x - flat0, spans)
    out["change_xt"] = _norms(xt - flat0, spans)
    return out
