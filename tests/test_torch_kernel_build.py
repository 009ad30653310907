"""The shared kernel build (``kernels/build.py``): every kernel of the port
has its source where the build looks for it, each library is keyed by a
hash of its source, its package's headers and the flags, and nothing is
built where there is no ``nvcc``.  Building and binding on the card is
``chip_smoke.py``'s first phase and the gpu-marked test below."""
import ctypes
import hashlib
import shutil

import pytest
import torch

from repro_torch.kernels import build

SIX = ("mixing_gossip_stacked", "channel_gossip_stacked",
       "mixing_gossip_worlds", "channel_gossip_worlds", "p2p_mixing",
       "mixing_p2p", "flash_attention_bhsd", "rmsnorm_2d")


def test_six_kernels_each_with_one_source():
    assert build.KERNELS == SIX
    for name in SIX:
        src = build.source(name)
        assert src.is_file() and src.parent.name == "csrc"
        assert f'extern "C" int {name}_launch(' in src.read_text()
    assert len({build.lib_path(n) for n in SIX}) == len(SIX) == 8


@pytest.mark.parametrize("name,headers", [
    ("mixing_gossip_stacked", ["gossip_common.cuh"]),
    ("mixing_p2p", ["gossip_common.cuh"]),
    ("flash_attention_bhsd", []),
    ("rmsnorm_2d", []),
])
def test_library_key_hashes_source_headers_and_flags(name, headers):
    src = build.source(name)
    assert sorted(p.name for p in src.parent.glob("*.cuh")) == headers
    blob = src.read_bytes() + b"".join(
        (src.parent / h).read_bytes() for h in headers)
    key = hashlib.sha256(blob + " ".join(build.NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    assert build.lib_path(name) == build.BUILD_DIR / f"lib{name}_{key}.so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_no_nvcc_means_no_build(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _: None)
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "_never")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(("rmsnorm_2d",))
    assert not (build.BUILD_DIR).exists()


@pytest.mark.gpu
def test_build_all_builds_and_binds_six_libraries():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    built = build.build_all()
    assert set(built) == set(SIX)
    for name, (path, log) in built.items():
        assert path.exists() and path == build.lib_path(name)
        assert hasattr(ctypes.CDLL(str(path)), f"{name}_launch")
