"""Plain PyTorch version of ``gemm_3xtf32``: the batched f32 product."""
from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (batch, M, K) @ b (batch, K, N) -> (batch, M, N)."""
    return torch.matmul(a, b)
