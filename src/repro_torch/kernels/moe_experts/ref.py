"""Plain PyTorch versions of the dropless expert kernels.

``moe_experts_ref`` is the oracle: every held expert over every token,
each weighted by the gates of the tokens that picked it (0 for the
others), so no routing table is read and nothing is dropped.  Its
autograd gives the gradients the kernels' backward must match.
``route_ref`` makes the kernels' routing tables ((worker, expert) groups
in order, each group's picks in (t, k) order) with sorts and counts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def experts_dense(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor) -> torch.Tensor:
    """Every held expert over every token: x (W, T, D), wg / wu (W, n, D,
    F), wd (W, n, F, D) -> (W, n, T, D)."""
    hg = torch.einsum("wtd,wndf->wntf", x, wg)
    hu = torch.einsum("wtd,wndf->wntf", x, wu)
    return torch.einsum("wntf,wnfd->wntd", F.silu(hg) * hu, wd)


def combine_dense(y: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor,
                  e0: int) -> torch.Tensor:
    """(W, T, D): each token's held experts' rows of y (W, n, T, D),
    weighted by its gates (ids / gates (W, T, K))."""
    held = torch.arange(e0, e0 + y.shape[1], device=ids.device)
    coef = ((ids[..., None] == held) * gates[..., None]).sum(-2)  # (W,T,n)
    return torch.einsum("wtn,wntd->wtd", coef, y)


def moe_experts_ref(x: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor,
                    wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                    e0: int) -> torch.Tensor:
    """x (W, T, D), ids / gates (W, T, K), wg / wu (W, n, D, F), wd (W, n,
    F, D) -> (W, T, D): sum over held picks of gate * SwiGLU expert."""
    return combine_dense(experts_dense(x, wg, wu, wd), ids, gates, e0)


def route_ref(ids: torch.Tensor, e0: int, n: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' (meta, row, pick) of ids (W, T, K) (``kernel.route``):
    a stable sort of the picks by group, held ones first."""
    w, t, k = ids.shape
    j = ids - e0
    held = (j >= 0) & (j < n)
    base = n * torch.arange(w, device=ids.device)[:, None, None]
    group = torch.where(held, j + base, w * n).reshape(-1)
    order = torch.sort(group, stable=True).indices
    counts = torch.bincount(group, minlength=w * n + 1)[:w * n]
    first = torch.cumsum(counts, 0) - counts
    meta = torch.cat([first.view(w, n), counts.view(w, n)], 1).int()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=ids.device)
    row = torch.where(held.reshape(-1), rank, -1).view(w, t, k).int()
    pick = order[:w * t * min(k, n)].int().view(w, -1)
    return meta, row, pick
