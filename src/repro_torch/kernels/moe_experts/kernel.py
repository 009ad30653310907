"""Binding of the hand-written dropless expert kernels
(``csrc/moe_experts.cu``), built and loaded by ``kernels/build.py``.

No TPU kernel of the JAX package corresponds: the JAX package dispatches
a MoE layer's picks into capacity buffers and drops what overflows.  Here
every held pick is one row of a packed buffer sized for the worst case (W
* T * min(K, n) rows); the group offsets are made and read on the card,
so nothing here waits for the card.

Three calls, each a fixed number of launches whatever the routing:
``route`` (1), ``products`` (2: the gate and up products, the down
product), ``combine`` (1: the gated sum of each token's rows) and
``backward`` (6: dy and the gates'
gradient, da, dWd, dWg with dWu, dx's rows, their combine).  Every launch
adds one to ``moe_experts.launches`` and to ``moe_experts.by_op``.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis import op_cost
from ..build import entry

OPS = {"route": 0, "up": 1, "down": 2, "combine": 3, "dy": 4, "da": 5,
       "dwd": 6, "dwgu": 7, "dxp": 8, "combine_dx": 9}
_P, _L = ctypes.c_void_p, ctypes.c_longlong


class MoeArgs(ctypes.Structure):
    """``struct MoeArgs`` of the source, field for field."""
    _fields_ = ([(k, _P) for k in ("ids", "x", "gates", "wg", "wu", "wd")]
                + [(k, _L) for k in ("w_stride_gu", "e_stride_gu",
                                     "w_stride_d", "e_stride_d")]
                + [(k, _P) for k in ("meta", "row", "pick", "hg", "hu", "y",
                                     "out", "dout", "dgates", "dy", "dhg",
                                     "dhu", "dxp", "dx", "dwg", "dwu",
                                     "dwd")]
                + [(k, _L) for k in ("W", "T", "K", "D", "F", "n", "e0")])


_ARGTYPES = (ctypes.c_int, ctypes.POINTER(MoeArgs), ctypes.c_void_p)


def moe_experts(op: str, args: MoeArgs, device: torch.device) -> None:
    """Queue one launch of ``op`` (``OPS``) on the current stream."""
    err = entry("moe_experts", _ARGTYPES)(
        OPS[op], ctypes.byref(args),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_experts {op} launch failed: CUDA error "
                           f"{err}")
    moe_experts.launches += 1
    moe_experts.by_op[op] = moe_experts.by_op.get(op, 0) + 1


moe_experts.launches = 0
moe_experts.by_op = {}


# the launch's limits: a token's picks staged in shared memory, a worker's
# held experts' cursors in shared memory
MAX_TOP_K, MAX_HELD = 32, 256


def _check(x: torch.Tensor, name: str, dtype=torch.float32,
           shape: tuple | None = None) -> None:
    """x is a contiguous CUDA tensor of ``dtype`` (and ``shape``)."""
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA {dtype} tensor, "
                         f"got {x.dtype} on {x.device}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _check_tables(meta, row, pick, w: int, t: int, k: int, n: int) -> None:
    """The routing tables of ``route`` for (W, T, K) picks, n held."""
    if not 1 <= n <= MAX_HELD or not 1 <= k <= MAX_TOP_K:
        raise ValueError(f"{n} held experts and top-{k} are outside the "
                         f"kernel's 1..{MAX_HELD} and 1..{MAX_TOP_K}")
    _check(meta, "meta", torch.int32, (w, 2 * n))
    _check(row, "row", torch.int32, (w, t, k))
    _check(pick, "pick", torch.int32, (w, t * min(k, n)))


def _weight_strides(w: torch.Tensor, name: str, shape: tuple
                    ) -> tuple[int, int]:
    """(worker, expert) strides of a (W, n, a, b) weight whose (a, b)
    matrices are each contiguous (the workers' and experts' may lie
    apart: a layer's slice of a stacked leaf)."""
    if not w.is_cuda or w.dtype != torch.float32:
        raise ValueError(f"{name} must be a CUDA float32 tensor, got "
                         f"{w.dtype} on {w.device}")
    if tuple(w.shape) != tuple(shape) or w.stride(3) != 1 \
            or w.stride(2) != w.shape[3]:
        raise ValueError(f"{name} must be (W, n, a, b) with contiguous (a, "
                         f"b) matrices, got {tuple(w.shape)} strides "
                         f"{w.stride()}")
    return w.stride(0), w.stride(1)


def _args(x, gates, wg, wu, wd, e0: int, **ptrs) -> MoeArgs:
    W, T, D = x.shape
    a = MoeArgs(W=W, T=T, K=gates.shape[-1], D=D, F=wg.shape[-1],
                n=wg.shape[1], e0=e0)
    for k, t in dict(x=x, gates=gates, wg=wg, wu=wu, wd=wd, **ptrs).items():
        setattr(a, k, t.data_ptr())
    n, F = wg.shape[1], wg.shape[-1]
    a.w_stride_gu, a.e_stride_gu = _weight_strides(wg, "w_gate",
                                                   (W, n, D, F))
    if _weight_strides(wu, "w_up", (W, n, D, F)) != (a.w_stride_gu,
                                                     a.e_stride_gu):
        raise ValueError("w_gate and w_up must share their strides")
    a.w_stride_d, a.e_stride_d = _weight_strides(wd, "w_down", (W, n, F, D))
    return a


def route(ids: torch.Tensor, e0: int, n: int, rows_max: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (W, T, K) int64 -> (meta (W, 2n) int32: each (worker, expert)
    group's first packed row, then its count; row (W, T, K) int32: each
    pick's packed row, -1 where the expert is not held; pick (W, rows_max
    / W) int32: each packed row's pick (w * T + t) * K + k, only the first
    sum(counts) meaningful).  One launch."""
    _check(ids, "ids", torch.int64)
    if ids.dim() != 3:
        raise ValueError(f"ids must be (W, T, K), got {tuple(ids.shape)}")
    W, T, K = ids.shape
    if not 1 <= n <= MAX_HELD or not 1 <= K <= MAX_TOP_K \
            or rows_max != W * T * min(K, n):
        raise ValueError(f"{n} held experts, top-{K} and {rows_max} rows "
                         f"do not fit the kernel")
    dev = ids.device
    meta = torch.empty((W, 2 * n), dtype=torch.int32, device=dev)
    row = torch.empty((W, T, K), dtype=torch.int32, device=dev)
    pick = torch.empty((W, rows_max // W), dtype=torch.int32, device=dev)
    a = MoeArgs(W=W, T=T, K=K, D=0, F=0, n=n, e0=e0, ids=ids.data_ptr(),
                meta=meta.data_ptr(), row=row.data_ptr(),
                pick=pick.data_ptr())
    moe_experts("route", a, dev)
    return meta, row, pick


def _rows(meta: torch.Tensor, n: int) -> int | None:
    """Held rows, read from the card only where an op counter is active
    (the dry run's count; the replay never has one)."""
    if not op_cost.counting():
        return None
    return int(meta[:, n:].sum())


def products(x, gates, meta, row, pick, wg, wu, wd, e0: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hg, hu (W, R/W, F), y (W, R/W, D)): the packed rows' gate and up
    products and their expert outputs, R the packed buffer's rows.  Two
    launches."""
    _check(x, "x")
    W, T, D = x.shape
    n, F = wg.shape[1], wg.shape[-1]
    _check(gates, "gates", shape=(W, T, row.shape[-1]))
    _check_tables(meta, row, pick, W, T, row.shape[-1], n)
    r = pick.shape[1]
    hg = x.new_empty((W, r, F))
    hu = x.new_empty((W, r, F))
    y = x.new_empty((W, r, D))
    a = _args(x, gates, wg, wu, wd, e0, meta=meta, row=row, pick=pick,
              hg=hg, hu=hu, y=y)
    moe_experts("up", a, x.device)
    moe_experts("down", a, x.device)
    rows = _rows(meta, n)
    if rows is not None:
        # x's rows, the weights, hg and hu written, read again, y written
        op_cost.record("moe_experts.products", 6.0 * rows * D * F,
                       4 * (rows * (2 * D + 4 * F) + 3 * W * n * D * F))
    return hg, hu, y


def combine(y, gates, row, T: int) -> torch.Tensor:
    """out (W, T, D) = sum over each token's held picks of gate * y[row].
    One launch."""
    W, K = row.shape[0], row.shape[-1]
    D = y.shape[-1]
    _check(y, "y")
    _check(row, "row", torch.int32, (W, T, K))
    _check(gates, "gates", shape=(W, T, K))
    out = y.new_empty((W, T, D))
    a = MoeArgs(W=W, T=T, K=K, D=D, F=0, n=1, e0=0, gates=gates.data_ptr(),
                row=row.data_ptr(), y=y.data_ptr(), out=out.data_ptr())
    moe_experts("combine", a, y.device)
    return out


def backward(dout, x, gates, meta, row, pick, wg, wu, wd, hg, hu, y,
             e0: int) -> tuple[torch.Tensor, ...]:
    """(dx, dgates, dwg, dwu, dwd) of ``combine(products(...))``.  Six
    launches."""
    W, T, D = x.shape
    n, F = wg.shape[1], wg.shape[-1]
    k = row.shape[-1]
    _check(dout, "dout", shape=(W, T, D))
    _check(x, "x")
    _check(gates, "gates", shape=(W, T, k))
    _check_tables(meta, row, pick, W, T, k, n)
    r = pick.shape[1]
    _check(hg, "hg", shape=(W, r, F))
    _check(hu, "hu", shape=(W, r, F))
    _check(y, "y", shape=(W, r, D))
    dy = torch.empty_like(y)
    dhg = torch.empty_like(hg)
    dhu = torch.empty_like(hu)
    dxp = torch.empty_like(y)
    dx = torch.empty_like(x)
    dgates = torch.empty_like(gates)
    dwg = x.new_empty((W, n, D, F))
    dwu = x.new_empty((W, n, D, F))
    dwd = x.new_empty((W, n, F, D))
    a = _args(x, gates, wg, wu, wd, e0, meta=meta, row=row,
              pick=pick, hg=hg, hu=hu, y=y, dout=dout, dgates=dgates, dy=dy,
              dhg=dhg, dhu=dhu, dxp=dxp, dx=dx, dwg=dwg, dwu=dwu, dwd=dwd)
    for op in ("dy", "da", "dwd", "dwgu", "dxp", "combine_dx"):
        moe_experts(op, a, x.device)
    rows = _rows(meta, n)
    if rows is not None:
        op_cost.record("moe_experts.backward", 12.0 * rows * D * F,
                       4 * (2 * W * T * D + rows * (3 * D + 4 * F)
                            + 6 * W * n * D * F))
    return dx, dgates, dwg, dwu, dwd
