"""Binding of the hand-written batched 3xTF32 product (``csrc/
gemm_3xtf32.cu``), built and loaded by ``kernels/build.py``.

No TPU kernel of the JAX package corresponds: the JAX package leaves the
model's weight products to XLA.  Here an f32 product runs on the tensor
cores as three TF32 products of each operand's split parts, where
PyTorch's f32 product (TF32 off) runs on the CUDA cores.

``gemm_3xtf32(a, b)`` takes a (batch, M, K) and b (batch, K, N) as they
lie: each operand K-major or MN-major (``operand_layout``), a batch
stride of 0 read as one matrix for every batch.  Each launch adds one to
``gemm_3xtf32.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis.op_cost import record
from ..build import entry

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# a, b, c, batch, m, n, k, a_bs, a_ld, a_kmajor, b_bs, b_ld, b_kmajor, stream
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _L, _L, _I, _P)
_INT_MAX = 2 ** 31 - 1


def operand_layout(t: torch.Tensor, k_dim: int) -> tuple | None:
    """How the kernel reads t (batch, ., .) whose K axis is ``k_dim`` (2
    for A, 1 for B): ``(k_major, leading stride, batch stride)`` in
    elements, or None where it cannot: TMA needs one of the two matrix
    axes at stride 1, the other stride and the batch stride in multiples
    of 16 bytes, and the data 16-byte aligned.  An axis of one element may
    have any stride; a batch of one reads as batch stride 0."""
    mn_dim = 3 - k_dim
    shape, stride = t.shape, t.stride()
    if t.data_ptr() % 16:
        return None
    bs = 0 if shape[0] == 1 else stride[0]
    if bs % 4 or bs < 0:
        return None
    for k_major, unit, lead in ((True, k_dim, mn_dim), (False, mn_dim, k_dim)):
        if stride[unit] != 1 and shape[unit] != 1:
            continue
        # an outer axis of one element: any aligned stride past the row
        ld = stride[lead] if shape[lead] != 1 else -(-shape[unit] // 4) * 4
        if ld > 0 and ld % 4 == 0:
            return k_major, ld, bs
    return None


def gemm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i] = A[i] B[i] on the card in 3xTF32: a (batch, M, K), b (batch,
    K, N), f32 CUDA tensors in layouts ``operand_layout`` reads.  Returns
    a fresh contiguous (batch, M, N) tensor.  The launch is queued on the
    current stream and not waited for."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("gemm_3xtf32 runs on CUDA tensors of one device; "
                         "CPU tensors take the plain version (ref.py)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gemm_3xtf32 takes float32, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"need a (batch, M, K) and b (batch, K, N), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    batch, m, k = a.shape
    n = b.shape[2]
    tiles = batch * -(-m // 128) * -(-n // 128)
    if min(batch, m, n, k) < 1 or max(m, n, k, tiles) > _INT_MAX:
        raise ValueError(f"sizes out of the kernel's range: {tuple(a.shape)}"
                         f", {tuple(b.shape)}")
    la, lb = operand_layout(a, 2), operand_layout(b, 1)
    if la is None or lb is None:
        raise ValueError(
            f"gemm_3xtf32 cannot read strides {a.stride()} / {b.stride()} "
            f"(one matrix axis at stride 1, the others in multiples of 4 "
            f"elements, 16-byte aligned data)")
    c = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = entry("gemm_3xtf32", _ARGTYPES)(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k,
            la[2], la[1], int(la[0]), lb[2], lb[1], int(lb[0]),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_3xtf32 launch failed: CUDA error {err}")
    gemm_3xtf32.launches += 1
    # FLOPs as torch.matmul's count them; each operand read once (one
    # matrix where its batch stride is 0), C written once
    record("gemm_3xtf32", 2.0 * batch * m * n * k,
           4 * (m * k * (batch if la[2] else 1)
                + k * n * (batch if lb[2] else 1) + batch * m * n))
    return c


gemm_3xtf32.launches = 0
