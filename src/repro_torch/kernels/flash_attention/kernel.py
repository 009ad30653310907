"""Binding of the hand-written flash attention kernel (``csrc/
flash_attention_bhsd.cu``), built and loaded by ``kernels/build.py``.

It replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``.  Like
that kernel it has no backward: a call whose inputs need a gradient raises
instead of silently taking the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...analysis.op_cost import record
from ..build import DTYPE_CODE, entry

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# dtype, q, k, v, out, bh, s_len, t_len, hd, causal, has_window, window,
# scale, stream
_ARGTYPES = (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)
# the kernel's instantiations; a head dim between them runs on the next one
HEAD_DIMS = (64, 128, 256)


def padded_head_dim(hd: int) -> int:
    """The instantiation a head dim runs on: the least of ``HEAD_DIMS`` that
    is at least ``hd``.  Raises above 256."""
    for h in HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(f"head dim {hd} > {HEAD_DIMS[-1]}: the kernel has no "
                     f"instantiation for it")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v with zero columns appended up to ``padded_head_dim``
    (the tensors themselves where hd is an instantiation).  The zero
    columns leave every q . k unchanged, and v's only make output columns
    that are cut off, so attention on the padded inputs at the real hd's
    scale, cut back to hd columns, is attention on the inputs."""
    pad = padded_head_dim(q.shape[-1]) - q.shape[-1]
    if pad == 0:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Causal / sliding-window attention on the card.

    q: (BH, S, hd), k/v: (BH, T, hd), contiguous CUDA tensors of one dtype
    (float32 or bfloat16), hd <= 256, BH <= 65535 (heads arrive
    pre-broadcast for GQA), each starting 16-byte aligned.  hd 64, 128 and
    256 run as they are; any other hd runs on the next of them, its inputs
    padded with zero columns (``pad_head_dim``) and the output cut back.
    bfloat16 runs on wgmma, float32 as 3xTF32 on wgmma and mma.sync
    (``csrc/``).  Returns a fresh (BH, S, hd) tensor in q's dtype.  A row
    with no live column is 0.  The launch is queued on the current stream
    and not waited for; each launch adds one to
    ``flash_attention_bhsd.launches``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_bhsd has no backward (nor has the Pallas "
            "kernel it replaces): train with attention_impl='xla', or run "
            "this forward under torch.no_grad()")
    if not q.is_cuda:
        raise ValueError("flash_attention_bhsd runs on CUDA tensors only; "
                         "CPU tensors take the plain version (ops.py)")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} is not supported by the CUDA "
                        f"kernel (float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, hd), (BH, T, hd)")
    bh, s_len, hd = q.shape
    t_len = k.shape[1]
    if k.shape != (bh, t_len, hd) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= hd <= HEAD_DIMS[-1] or not 1 <= bh <= 65535 or not s_len \
            or not t_len:
        raise ValueError(f"need 1 <= hd <= {HEAD_DIMS[-1]}, 1 <= BH <= "
                         f"65535, S and T >= 1; got {tuple(q.shape)}, "
                         f"T = {t_len}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start 16-byte aligned (the kernel "
                         "copies 16 bytes at a time)")
    scale = scale if scale is not None else hd ** -0.5
    q, k, v = pad_head_dim(q, k, v)
    hd_run = q.shape[-1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = entry("flash_attention_bhsd", _ARGTYPES)(
            DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bh, s_len, t_len, hd_run, int(causal),
            int(window is not None), 0 if window is None else int(window),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bhsd.launches += 1
    # FLOPs as the plain version's two einsums count them (every (s, t)
    # pair, at the real head dim); q, k, v read once, out written once
    record("flash_attention_bhsd", 4.0 * bh * s_len * t_len * hd,
           (2 * s_len + 2 * t_len) * bh * hd * q.element_size())
    return out if hd_run == hd else out[..., :hd].contiguous()


flash_attention_bhsd.launches = 0
