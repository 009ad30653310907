"""Flash attention in the model layout (B, S, H, hd), after the JAX
package's ``repro.kernels.flash_attention.ops``.

KV heads are repeated for GQA and (B, H) is flattened; a CUDA tensor then
launches the Hopper kernel (or the call raises: there is no fallback), a
CPU tensor takes the plain version.  ``backend="ref"`` forces the plain
version on any device.
"""
from __future__ import annotations

import torch

from .. import resolve_backend
from .kernel import flash_attention_bhsd
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0 -> (B, S, H,
    hd)."""
    b, s_len, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    t_len = k.shape[1]
    # contiguous: at B == 1 the reshape is a strided view, not a copy
    qf = q.transpose(1, 2).reshape(b * h, s_len, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, t_len, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, t_len, hd).contiguous()
    if resolve_backend(backend, q) == "ref":
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
    else:
        out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, s_len, hd).transpose(1, 2)
