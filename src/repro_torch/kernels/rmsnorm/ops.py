"""RMSNorm over the last axis with any leading dims, after the JAX
package's ``repro.kernels.rmsnorm.ops``: a CUDA tensor launches the Hopper
kernel on the flattened (T, D) rows (or the call raises: there is no
fallback), a CPU tensor takes the plain version.  ``backend="ref"`` forces
the plain version on any device."""
from __future__ import annotations

import torch

from .. import resolve_backend
from .kernel import rmsnorm_2d
from .ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            backend: str = "auto") -> torch.Tensor:
    if resolve_backend(backend, x) == "ref":
        return rmsnorm_ref(x, scale, eps)
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    return rmsnorm_2d(flat, scale, eps=eps).reshape(x.shape)
