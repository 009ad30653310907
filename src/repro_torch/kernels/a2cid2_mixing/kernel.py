"""Hopper kernel for the fused A2CiD2 gossip batch, built and bound by hand.

``csrc/mixing_gossip_stacked.cu`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C entry point, at first use, into the
repository's ``build/`` directory, keyed by a hash of the source and the
flags; it is loaded with ``ctypes``.  Nothing is built or loaded when this
module is imported, so the CPU tests import it freely.

The kernel replaces the JAX package's Pallas TPU kernel
``repro/kernels/a2cid2_mixing/kernel.py::mixing_gossip_stacked``; the
source file states what it computes, what bounds it and how it is laid out.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "mixing_gossip_stacked.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LANE = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernel can only be built "
                       "where the CUDA toolkit is installed")


def build() -> tuple[Path, str]:
    """Compile the kernel library if this source and these flags have not
    been built yet.  Returns its path and the compiler's ``-Xptxas -v``
    report (registers, shared memory, spills)."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmixing_gossip_stacked_{key}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    return lib, log.read_text() if log.exists() else ""


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.mixing_gossip_stacked_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, x_tilde: torch.Tensor, partner: torch.Tensor,
           dt_next: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError("mixing_gossip_stacked runs on CUDA tensors only; "
                         "CPU tensors take the plain version (ops.py)")
    for name, t in (("x_tilde", x_tilde), ("partner", partner),
                    ("dt_next", dt_next)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("x_tilde", x_tilde), ("partner", partner),
                    ("dt_next", dt_next)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"buffer dtype {x.dtype} is not supported by the "
                        f"CUDA kernel (float32, bfloat16)")
    if x_tilde.dtype != x.dtype:
        raise TypeError(f"x_tilde is {x_tilde.dtype}, x is {x.dtype}")
    if x.dim() != 2 or x_tilde.shape != x.shape:
        raise ValueError(f"x and x_tilde must share one (W, D) shape, got "
                         f"{tuple(x.shape)} and {tuple(x_tilde.shape)}")
    w, d = x.shape
    if not 1 <= w <= 65535 or d % LANE:
        raise ValueError(f"need 1 <= W <= 65535 and D % {LANE} == 0, got "
                         f"({w}, {d})")
    if partner.dtype != torch.int32 or partner.shape != (w,):
        raise ValueError(f"partner must be ({w},) int32, got "
                         f"{tuple(partner.shape)} {partner.dtype}")
    if dt_next.dtype != torch.float32 or dt_next.shape != (w,):
        raise ValueError(f"dt_next must be ({w},) float32, got "
                         f"{tuple(dt_next.shape)} {dt_next.dtype}")
    if x.data_ptr() % 16 or x_tilde.data_ptr() % 16:
        raise ValueError("x and x_tilde must be 16-byte aligned")


def mixing_gossip_stacked(x: torch.Tensor, x_tilde: torch.Tensor,
                          partner: torch.Tensor, dt_next: torch.Tensor, *,
                          eta: float, alpha: float, alpha_t: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One coalesced gossip batch on the card: p2p then mix.

    x, x_tilde: (W, D) float32 or bfloat16, contiguous, D % 128 == 0;
    partner: (W,) int32 involution on the same device (partner[w] == w for
    idle workers; its values are trusted, not checked, since checking them
    would synchronise with the card); dt_next: (W,) float32.

    ``x_tilde`` is updated IN PLACE, as the Pallas kernel aliases it to its
    output; the returned pair is ``(out_x, x_tilde)`` with ``out_x`` fresh.
    The launch is queued on the current stream and not waited for.  Each
    launch adds one to ``mixing_gossip_stacked.launches``.
    """
    _check(x, x_tilde, partner, dt_next)
    w, d = x.shape
    out_x = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().mixing_gossip_stacked_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x_tilde.data_ptr(),
            out_x.data_ptr(), partner.data_ptr(), dt_next.data_ptr(), w, d,
            float(-2.0 * eta), float(alpha), float(alpha_t), stream)
    if err != 0:
        raise RuntimeError(f"mixing_gossip_stacked launch failed: CUDA "
                           f"error {err}")
    mixing_gossip_stacked.launches += 1
    return out_x, x_tilde


mixing_gossip_stacked.launches = 0
