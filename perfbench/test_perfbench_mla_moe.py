"""The ``mla_moe`` architecture through the harness on the CPU at a small
size: a cell added as files in a temporary copy of the benchmark runs
traced and untraced and comes out correct; the planted MoE faults
(capacity dispatch at 1.25, gates from the biased scores) read above the
sound run's numbers; the MoE spans' readers (``program_moe.py``) read a
traced call and say nothing of a program without the layer."""
from __future__ import annotations

import io
import json
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import calibrate_moe, check, harness, program_moe, spec
from perfbench.conftest import HERE, LIMITS, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 32 + 777
CELL = "tiny_moe.ring3_s32"


@pytest.fixture(scope="module")
def moe_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_moe")
    here = root / "perfbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*", "conftest.py"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs/kanana2_30b_a3b.json").read_text())
    cfg.update(name="tiny-moe", hidden_size=64, num_attention_heads=4,
               kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, router_experts=16,
               n_routed_experts=4, num_experts_per_tok=4, vocab_size=500,
               num_hidden_layers=3)
    (here / "configs/tiny_moe.json").write_text(json.dumps(cfg))
    (here / f"workloads/{CELL}.json").write_text(json.dumps({
        "config": "tiny_moe",
        "traffic": {"graph": "ring", "workers": 3, "comms_per_grad": 1.0,
                    "accelerated": True, "batch": 1, "seq": 32},
        "stream": {"kind": "tokens", "copy_p": 0.5}, "step_size": 0.01,
        "rounds_per_call": 2, "max_rounds_per_s": 1000, "check": LIMITS}))
    bench["configs"].append({"name": "tiny_moe", "source": "test",
                             "file": "perfbench/configs/tiny_moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_moe",
                               "traffic": "ring3_s32", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith(".lm") or m["name"] == "tokens_per_s":
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.Bench(root, here)


@pytest.mark.parametrize("traced", [False, True])
def test_moe_cell_runs_and_is_correct(moe_bench, traced):
    result, numbers, limits = harness.run_cell(
        moe_bench, CELL, SEED, 0.3, traced, CPU, time.perf_counter())
    out = json.loads(harness.finish(result, numbers, limits))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    key = "grad_ms.lm" if traced else "tokens_per_s"
    assert out["metrics"][key]["value"] > 0


def test_planted_moe_faults_read_above_the_sound_run(moe_bench):
    cell = harness.Cell(moe_bench, CELL)
    run = harness.build(cell, SEED, 0.0, CPU)
    sound, _ = check.compare(run.prog, harness.reference(
        cell, SEED, run.arrays, run.stream, CPU))
    faults = calibrate_moe.readings(moe_bench, CELL, [SEED], CPU,
                                    out=io.StringIO())["upper"]
    assert set(faults) == {"capacity", "biased_gates"}
    for fault, gaps in faults.items():
        assert max(gaps[k] / max(sound[k], 1e-12) for k in check.NAMES) \
            > 10, fault


def test_moe_readers_read_a_traced_call(moe_bench):
    from repro_torch.analysis import SpanTracer
    cell = harness.Cell(moe_bench, CELL)
    run = harness.build(cell, SEED, 1.0, CPU)
    tracer = SpanTracer("test")
    w0 = tracer.now_us()
    with tracer.activate():
        run.sim.run_schedule(run.state, harness.port_schedule(
            run.arrays, 3, 5))
    prog = {"events": tracer.resolve().events,
            "window": (w0, tracer.now_us()), "profile": None}
    ctx = SimpleNamespace(program=prog)
    names = {e["name"] for e in prog["events"] if e.get("ph") == "X"}
    assert set(program_moe.SPANS) <= names
    counters = [e["args"] for e in prog["events"]
                if e.get("ph") == "C" and e["name"] == "moe"]
    # 2 MoE layers a tick, 2 ticks; every value read at resolve
    assert len(counters) == 4
    for c in counters:
        assert c["groups"] == 3 * 4 and 0 < c["largest"] <= c["rows"]
        assert c["rows"] <= 3 * 32 * 4
        assert c["flops"] == c["rows"] * 18 * 64 * 32
    assert program_moe.moe_ms(ctx) > 0
    assert np.isfinite(program_moe.experts_roofline_pct(ctx))
    # a program without the layer, or no program spans: nothing
    none = SimpleNamespace(program={"events": [], "window": (0, 1),
                                    "profile": None})
    assert program_moe.moe_ms(none) is None
    assert program_moe.experts_roofline_pct(none) is None
    assert program_moe.moe_ms(SimpleNamespace()) is None


def test_host_syncs_names_calls_inside_the_ranges():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "replay.call",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "moe.experts",
         "ts": 10, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 50, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 60, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 15, "dur": 1}]
    assert program_moe.host_syncs(events) == {
        "replay.call": {"cudaMemcpyAsync: Memcpy DtoH": 1,
                        "cudaStreamSynchronize": 1},
        "moe.experts": {"cudaStreamSynchronize": 1}}
