"""Plain PyTorch version of the fused RMSNorm, after the JAX package's
oracle (``repro.kernels.rmsnorm.ref``): f32 throughout, cast back to x's
dtype at the end.  (The models normalise with ``models.layers.rmsnorm``,
whose rounding differs; neither package's models call this kernel.)"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * (1.0 + scale.float())).to(x.dtype)
