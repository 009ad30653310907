"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary folder with two small cells added as files (a ResNet-8 and a
two-layer Qwen3-style decoder), and entries for them in its
``BENCHMARK.json`` — what a later PR adding a cell does."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RESNET = "resnet8_cifar.ring4_b4"
LM = "tiny_lm.ring3_s32"
LIMITS = {"first_loss_gap": 1e-6, "grad_gap": 1e-3, "change_gap": 1e-3}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    """(checkout root, benchmark folder) of the copy."""
    from perfbench import spec
    root = tmp_path_factory.mktemp("bench")
    here = root / "perfbench"
    shutil.copytree(HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*",
                                                  "conftest.py"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    resnet = json.loads((HERE / "configs/resnet18_cifar.json").read_text())
    resnet.update(name="resnet8", stage_sizes=[1, 1, 1], width=16, groups=4)
    _write(here / "configs/resnet8_cifar.json", resnet)
    lm = json.loads((HERE / "configs/qwen3_0_6b.json").read_text())
    lm.update(name="tiny-lm", hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, intermediate_size=128,
              num_hidden_layers=2, vocab_size=500)
    _write(here / "configs/tiny_lm.json", lm)
    common = {"step_size": 0.01, "rounds_per_call": 2,
              "max_rounds_per_s": 1000, "check": LIMITS}
    _write(here / f"workloads/{RESNET}.json", {
        "config": "resnet8_cifar",
        "traffic": {"graph": "ring", "workers": 4, "comms_per_grad": 1.0,
                    "accelerated": True, "batch": 4},
        "stream": {"kind": "cifar", "noise": 0.6}, **common})
    _write(here / f"workloads/{LM}.json", {
        "config": "tiny_lm",
        "traffic": {"graph": "ring", "workers": 3, "comms_per_grad": 1.0,
                    "accelerated": True, "batch": 2, "seq": 32},
        "stream": {"kind": "tokens", "copy_p": 0.5}, **common})
    for name, file in (("resnet8_cifar", "resnet8_cifar"),
                       ("tiny_lm", "tiny_lm")):
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"perfbench/configs/{file}.json",
                                 "reduced": [], "why": "test"})
    for cell, cfg, kind in ((RESNET, "resnet8_cifar", "resnet"),
                            (LM, "tiny_lm", "lm")):
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": cell.split(".")[1],
                                   "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            unit = {"resnet": "images_per_s", "lm": "tokens_per_s"}[kind]
            if m["name"].endswith("." + kind) or m["name"] == unit:
                m["workloads"].append(cell)
    _write(root / "BENCHMARK.json", bench)
    return spec.Bench(root, here)
