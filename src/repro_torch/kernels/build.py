"""Build and bind the port's hand-written CUDA kernels.

Every kernel is one ``<package>/csrc/<name>.cu`` with one plain C entry
point, ``<name>_launch``.  At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library in the repository's ``build/`` directory,
keyed by a hash of the source, the headers of its package (``csrc/*.cuh``)
and the flags, and loaded with ``ctypes``.  ``build_all`` starts one
``nvcc`` per missing library, all at once.  Nothing is built or loaded when
this module is imported, so the CPU tests import it freely.  ``root``
names another tree of the same packages (an edited copy, or an earlier
version, to time against): its libraries take their own keys.  With a
tracer active (``analysis.tracing``) each build is a ``kernels.build`` span
and each library load a ``kernels.load`` span, and the counters of the
same names count them by kernel.
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

from ..analysis import tracing

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
    "tick_tail_stacked": "a2cid2_mixing",
    "flash_attention_bhsd": "flash_attention",
    "rmsnorm_2d": "rmsnorm",
    "moe_experts": "moe_experts",
    "gemm_3xtf32": "dense_f32",
}
KERNELS = tuple(PACKAGES)
# the dtype argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def toolkit_tool(name: str = "nvcc") -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on the
    PATH, else in the toolkit that PyTorch finds."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / name).exists():
        return str(Path(CUDA_HOME) / "bin" / name)
    raise RuntimeError(f"{name} not found: the CUDA kernels can only be "
                       f"built where the CUDA toolkit is installed")


def source(name: str, root: Path = _KERNELS_DIR) -> Path:
    return root / PACKAGES[name] / "csrc" / f"{name}.cu"


def lib_path(name: str, root: Path = _KERNELS_DIR) -> Path:
    src = source(name, root)
    parts = [src, *sorted(src.parent.glob("*.cuh"))]
    key = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all(names=KERNELS, root: Path = _KERNELS_DIR
              ) -> dict[str, tuple[Path, str]]:
    """Compile every named kernel library that this source and these flags
    have not built yet, one ``nvcc`` each, all started together.  Returns
    ``{name: (library path, the compiler's -Xptxas -v report)}``."""
    missing = [name for name in names if not lib_path(name, root).exists()]
    if missing:
        with tracing.span("kernels.build", kernels=",".join(missing)):
            _build(missing, root)
        tracing.count("kernels.build", **dict.fromkeys(missing, 1))
    out = {}
    for name in names:
        lib = lib_path(name, root)
        log = lib.with_suffix(".log")
        out[name] = (lib, log.read_text() if log.exists() else "")
    return out


def _build(names, root: Path) -> None:
    """One ``nvcc`` for each of ``names``, all started together."""
    nvcc = toolkit_tool()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = lib_path(name, root)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        jobs[name] = (lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name, root))],
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


@functools.cache
def entry(name: str, argtypes: tuple):
    """The kernel's ``<name>_launch`` C function, built if needed, with its
    argument types set (a pointer is ``c_void_p``: an untyped int would be
    cut to 32 bits) and an ``int`` result, the launch's CUDA error code."""
    path, _ = build_all((name,))[name]
    return bind(path, name, argtypes)


def bind(path: Path, name: str, argtypes: tuple):
    """``<name>_launch`` of the library at ``path``, typed as ``entry``
    types it."""
    with tracing.span("kernels.load", kernel=name):
        fn = getattr(ctypes.CDLL(str(path)), f"{name}_launch")
    tracing.count("kernels.load", **{name: 1})
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
