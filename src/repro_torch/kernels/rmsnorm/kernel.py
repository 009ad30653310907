"""Binding of the hand-written RMSNorm kernel (``csrc/rmsnorm_2d.cu``),
built and loaded by ``kernels/build.py``.

It replaces the JAX package's Pallas TPU kernel
``repro/kernels/rmsnorm/kernel.py::rmsnorm_2d``.  As there, no model calls
it: it is a standalone op (``ops.rmsnorm``).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import DTYPE_CODE, entry

# dtype, x, scale, out, rows, d, eps, stream
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
               ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) over the rows of x on the
    card, f32 inside.

    x: (T, D) contiguous CUDA tensor, float32 or bfloat16; scale: (D,) of
    the same dtype (stored as the deviation from 1).  Returns a fresh (T, D)
    tensor in x's dtype.  The launch is queued on the current stream and
    not waited for; each launch adds one to ``rmsnorm_2d.launches``.
    """
    if not x.is_cuda:
        raise ValueError("rmsnorm_2d runs on CUDA tensors only; CPU tensors "
                         "take the plain version (ops.py)")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"dtype {x.dtype} is not supported by the CUDA "
                        f"kernel (float32, bfloat16)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (T, D), got "
                         f"{tuple(x.shape)}")
    rows, d = x.shape
    if scale.shape != (d,) or scale.dtype != x.dtype \
            or scale.device != x.device:
        raise ValueError(f"scale must be a ({d},) {x.dtype} tensor on "
                         f"{x.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = entry("rmsnorm_2d", _ARGTYPES)(
            DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, d, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_2d launch failed: CUDA error {err}")
    rmsnorm_2d.launches += 1
    return out


rmsnorm_2d.launches = 0
