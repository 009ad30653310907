"""Plain PyTorch version of flash attention, after the JAX package's oracle
(``repro.kernels.flash_attention.ref``): f32 scores, NEG_INF masking and a
full softmax.

One deliberate difference from the kernel, inherited from the JAX package:
a row with no live column (possible only with a window and no causal mask)
comes out here as the mean of v (the softmax of a row of -1e30), where the
kernel writes 0.  Compare the two on live rows only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(s_len: int, t_len: int, *, causal: bool = True,
                   window: int | None = None, device=None) -> torch.Tensor:
    """(S, T) boolean mask of live (row, column) pairs: absolute causal
    (``col <= row``) and window (``col > row - window``) conditions."""
    rows = torch.arange(s_len, device=device)[:, None]
    cols = torch.arange(t_len, device=device)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: (BH, S, hd), k/v: (BH, T, hd) -> (BH, S, hd) in q's dtype."""
    s_len, t_len, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bsh,bth->bst", q.float(), k.float()) * scale
    mask = attention_mask(s_len, t_len, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,bth->bsh", p, v.float()).to(q.dtype)
