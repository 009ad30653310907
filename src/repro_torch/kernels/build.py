"""Build and bind the port's hand-written CUDA kernels.

Every kernel is one ``<package>/csrc/<name>.cu`` with one plain C entry
point, ``<name>_launch``.  At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library in the repository's ``build/`` directory,
keyed by a hash of the source, the headers of its package (``csrc/*.cuh``)
and the flags, and loaded with ``ctypes``.  ``build_all`` starts one
``nvcc`` per missing library, all at once.  Nothing is built or loaded when
this module is imported, so the CPU tests import it freely.
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

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel name -> the package whose csrc/ holds <name>.cu
PACKAGES = {
    "mixing_gossip_stacked": "a2cid2_mixing",
    "channel_gossip_stacked": "a2cid2_mixing",
    "mixing_gossip_worlds": "a2cid2_mixing",
    "channel_gossip_worlds": "a2cid2_mixing",
    "p2p_mixing": "a2cid2_mixing",
    "mixing_p2p": "a2cid2_mixing",
    "flash_attention_bhsd": "flash_attention",
    "rmsnorm_2d": "rmsnorm",
}
KERNELS = tuple(PACKAGES)
# the dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def source(name: str) -> Path:
    return _KERNELS_DIR / PACKAGES[name] / "csrc" / f"{name}.cu"


def lib_path(name: str) -> Path:
    src = source(name)
    parts = [src, *sorted(src.parent.glob("*.cuh"))]
    key = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all(names=KERNELS) -> dict[str, tuple[Path, str]]:
    """Compile every named kernel library that this source and these flags
    have not built yet, one ``nvcc`` each, all started together.  Returns
    ``{name: (library path, the compiler's -Xptxas -v report)}``."""
    missing = [name for name in names if not lib_path(name).exists()]
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in missing:
        lib = lib_path(name)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        jobs[name] = (lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    out = {}
    for name in names:
        lib = lib_path(name)
        log = lib.with_suffix(".log")
        out[name] = (lib, log.read_text() if log.exists() else "")
    return out


@functools.cache
def entry(name: str, argtypes: tuple):
    """The kernel's ``<name>_launch`` C function, built if needed, with its
    argument types set (a pointer is ``c_void_p``: an untyped int would be
    cut to 32 bits) and an ``int`` result, the launch's CUDA error code."""
    path, _ = build_all((name,))[name]
    fn = getattr(ctypes.CDLL(str(path)), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
