"""Binding of the hand-written RMSNorm kernel (``csrc/rmsnorm_2d.cu``),
built and loaded by ``kernels/build.py``.

It replaces the JAX package's Pallas TPU kernel
``repro/kernels/rmsnorm/kernel.py::rmsnorm_2d``.  As there, no model calls
it: it is a standalone op (``ops.rmsnorm``).
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis.op_cost import record
from ..build import DTYPE_CODE, entry

# dtype, x, scale, out, rows, d, eps, stream
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
               ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) over the rows of x on the
    card, f32 inside.

    x: (T, D) contiguous CUDA tensor, float32 or bfloat16, at any element
    offset; scale: (D,) of the same dtype (stored as the deviation from 1).
    Returns a fresh contiguous (T, D) tensor in x's dtype.  It starts as far
    from a 16-byte boundary as x does, so that the kernel's vector loads and
    stores line up: for an x off a boundary it is a view, at a storage
    offset below 16 bytes, of an allocation 16 bytes longer.  The launch
    is queued on the current stream and not waited for; each launch adds
    one to ``rmsnorm_2d.launches``.
    """
    if not x.is_cuda:
        raise ValueError("rmsnorm_2d runs on CUDA tensors only; CPU tensors "
                         "take the plain version (ops.py)")
    code = DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"dtype {x.dtype} is not supported by the CUDA "
                        f"kernel (float32, bfloat16)")
    shape = x.shape
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"x must be a non-empty (T, D), got {tuple(shape)}")
    rows, d = shape
    dev = x.get_device()
    if scale.shape != (d,) or scale.dtype != x.dtype \
            or scale.get_device() != dev:
        raise ValueError(f"scale must be a ({d},) {x.dtype} tensor on "
                         f"{x.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return rmsnorm_2d(x, scale, eps=eps)
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        size = x.element_size()
        out = torch.empty(x.numel() + 16 // size, dtype=x.dtype,
                          device=x.device)[x_ptr % 16 // size:][:x.numel()]
        out = out.view(rows, d)
    else:
        out = torch.empty_like(x)
    err = entry("rmsnorm_2d", _ARGTYPES)(
        code, x_ptr, scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_2d launch failed: CUDA error {err}")
    rmsnorm_2d.launches += 1
    # x and scale read once, out written once; no matmul
    record("rmsnorm_2d", 0.0, (2 * rows * d + d) * x.element_size())
    return out


rmsnorm_2d.launches = 0
