"""The shared kernel build (``kernels/build.py``): every kernel of the port
has its source where the build looks for it, each library is keyed by a
hash of its source, its package's headers and the flags, and nothing is
built where there is no ``nvcc``; another tree of the packages (the
variant sweep's edited copies) takes keys of its own.  Building and
binding on the card is
``chip_smoke.py``'s first phase and the gpu-marked test below.  With a
tracer active a build is a ``kernels.build`` span and counter, a load a
``kernels.load`` one."""
import ctypes
import hashlib
import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import SpanTracer
from repro_torch.kernels import build

SIX = ("mixing_gossip_stacked", "channel_gossip_stacked",
       "mixing_gossip_worlds", "channel_gossip_worlds", "p2p_mixing",
       "mixing_p2p", "tick_tail_stacked", "flash_attention_bhsd",
       "rmsnorm_2d", "moe_experts", "gemm_3xtf32")


def test_six_kernels_each_with_one_source():
    assert build.KERNELS == SIX
    for name in SIX:
        src = build.source(name)
        assert src.is_file() and src.parent.name == "csrc"
        assert f'extern "C" int {name}_launch(' in src.read_text()
    assert len({build.lib_path(n) for n in SIX}) == len(SIX) == 11


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


def test_another_root_takes_its_own_key(tmp_path):
    src = build.source("rmsnorm_2d")
    copy = tmp_path / "rmsnorm" / "csrc"
    shutil.copytree(src.parent, copy)
    assert build.source("rmsnorm_2d", tmp_path) == copy / src.name
    assert build.lib_path("rmsnorm_2d", tmp_path) == \
        build.lib_path("rmsnorm_2d")
    (copy / src.name).write_text(src.read_text() + "// edited\n")
    assert build.lib_path("rmsnorm_2d", tmp_path) != \
        build.lib_path("rmsnorm_2d")


@pytest.mark.parametrize("name", ["mixing_gossip_stacked", "rmsnorm_2d",
                                  "mixing_p2p", "flash_attention_bhsd"])
def test_sweep_variants_edit_the_sources(monkeypatch, tmp_path, name):
    """Every edit of ``tools/kernel_sweep.py`` still finds its text once in
    the kernel's source, so each variant builds from its own key."""
    spec = importlib.util.spec_from_file_location(
        "kernel_sweep", Path(__file__).parents[1] / "tools" /
        "kernel_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    roots = sweep.variant_roots(name, None)
    assert list(roots) == ["as is", *sweep.VARIANTS[name]]
    assert roots["as is"] == build.source(name).parents[2]
    for label, edits in sweep.VARIANTS[name].items():
        text = build.source(name, roots[label]).read_text()
        assert all(new in text for _, new in edits if new)
    assert len({build.lib_path(name, r) for r in roots.values()}) == \
        len(roots)


def test_build_is_a_span_and_a_counter(monkeypatch, tmp_path):
    """Only a missing library is built, under one ``kernels.build`` span
    naming it, and counted by kernel; the compiler's part is stood in for
    (there is no ``nvcc`` here)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def fake_build(names, root):
        for name in names:
            build.lib_path(name, root).write_text("")
    monkeypatch.setattr(build, "_build", fake_build)
    tracer = SpanTracer("test")
    with tracer.activate():
        build.build_all(("rmsnorm_2d", "p2p_mixing"))
        build.build_all(("rmsnorm_2d",))
    (span,) = [e for e in tracer.events if e["ph"] == "X"]
    assert span["name"] == "kernels.build"
    assert span["args"]["kernels"] == "rmsnorm_2d,p2p_mixing"
    (sample,) = [e for e in tracer.events if e["ph"] == "C"]
    assert sample["name"] == "kernels.build"
    assert sample["args"] == {"rmsnorm_2d": 1.0, "p2p_mixing": 1.0}


@pytest.mark.gpu
def test_build_all_builds_and_binds_six_libraries():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    built = build.build_all()
    assert set(built) == set(SIX)
    for name, (path, log) in built.items():
        assert path.exists() and path == build.lib_path(name)
        assert hasattr(ctypes.CDLL(str(path)), f"{name}_launch")
    tracer = SpanTracer("test")
    with tracer.activate():
        build.bind(built["rmsnorm_2d"][0], "rmsnorm_2d", ())
    assert [e["args"]["kernel"] for e in tracer.events
            if e["name"] == "kernels.load" and e["ph"] == "X"] == \
        ["rmsnorm_2d"]
