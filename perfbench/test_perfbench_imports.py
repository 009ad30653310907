"""What a run loads, and how it refuses: a fresh process that imports every
module of the benchmark and runs a cell through the harness holds no
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (names compared whole: the port ``repro_torch`` starts
with ``repro``); the reference alone loads nothing of the port; with no
card, or in a directory that holds only the benchmark, ``run.py`` exits
with another code than 0 and prints no result."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from perfbench.conftest import HERE, RESNET, ROOT

PROBE = """
import json, pkgutil, importlib, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
import perfbench
from perfbench import harness, spec
for sub in ("", "models", "streams", "reference"):
    pkg = importlib.import_module("perfbench" + ("." + sub if sub else ""))
    for m in pkgutil.iter_modules(pkg.__path__):
        if not m.name.startswith(("test_", "conftest")):
            importlib.import_module(pkg.__name__ + "." + m.name)
bench = spec.Bench({bench_root!r}, {bench_here!r})
for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
    bench.reader(m["name"])
harness.finish(*harness.run_cell(bench, {cell!r}, 5, 0.2, True,
                                 torch.device("cpu"), time.perf_counter()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_bench):
    names = _top_level(PROBE.format(
        root=str(ROOT), src=str(ROOT / "src"), bench_root=str(tiny_bench.root),
        bench_here=str(tiny_bench.here), cell=RESNET))
    assert "repro_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_by_whole_name():
    from perfbench import harness
    clean = ["repro_torch", "repro_torch.core.simulator", "jaxtyping",
             "flaxen.x", "torch"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(
        clean + ["repro.core.simulator", "jax.numpy", "flax"]) == \
        ["flax", "jax", "repro"]


def test_reference_loads_nothing_of_the_port():
    names = _top_level(
        f"import json, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
        "import perfbench.reference.replay, perfbench.reference.resnet\n"
        "import perfbench.reference.transformer\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


def _run_py(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "resnet18_cifar.ring16_b32", "--seed", str(2 ** 31 + 9),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=600, cwd=cwd, env={"PATH": "/usr/bin:/bin"})


def test_no_card_no_result():
    out = _run_py(ROOT)
    if out.returncode == 0:
        # a card is here: the run printed its line
        assert json.loads(out.stdout.splitlines()[-1])["correct"] in (True,
                                                                      False)
        return
    assert out.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
