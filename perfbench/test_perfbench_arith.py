"""The yardstick's arithmetic against values worked out by hand: the
models' FLOPs, the comm step's least bytes, the trace's reduction, the
output check's gaps."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import check, layers, peaks, spec, trace
from perfbench.conftest import ROOT
from perfbench.models import resnet, transformer

BENCH = spec.Bench(ROOT)


def test_resnet18_flops_by_hand():
    cfg = BENCH.config("resnet18_cifar")
    stem = 2 * 9 * 3 * 64 * 32 * 32
    stage1 = 4 * 2 * 9 * 64 * 64 * 32 * 32
    # conv1 at stride 2, conv2, the 1x1 projection, then a block of two
    stage2 = (2 * 9 * 64 * 128 * 256 + 2 * 9 * 128 * 128 * 256
              + 2 * 64 * 128 * 256 + 2 * 2 * 9 * 128 * 128 * 256)
    head = 2 * 512 * 10
    assert stage2 == 268_435_456
    fwd = stem + stage1 + 3 * stage2 + head
    assert fwd == 1_110_845_440
    assert resnet.forward_flops_per_image(cfg) == fwd
    traffic = BENCH.workload("resnet18_cifar.ring16_b32")["traffic"]
    assert resnet.flops_per_round(cfg, traffic) == 3 * fwd * 16 * 32


def test_qwen3_flops_by_hand():
    cfg = BENCH.config("qwen3_0_6b")
    per_layer = (1024 * 2048 * 2 + 1024 * 1024 * 2) + 3 * 1024 * 3072
    n = 10 * per_layer + 152_064 * 1024
    assert n == 312_999_936 == transformer.matmul_params(cfg)
    traffic = BENCH.workload("qwen3_0_6b.ring4_s1024")["traffic"]
    attn = 6 * 10 * 16 * 128 * 1024 ** 2
    assert transformer.flops_per_round(cfg, traffic) == \
        4 * (6 * n * 1024 + attn) == 8_207_682_502_656


def test_comm_roofline_by_hand():
    # 3 comm steps of (16, 1000) f32 rows in 1 us each: 4 * 16 * 1000 * 4
    # least bytes a step at 3.35 TB/s
    ctx = SimpleNamespace(spans={"comm": [1e-6] * 3}, workers=16,
                          d_real=1000, elem_bytes=4)
    want = 100 * 256_000 / peaks.HBM_BYTES_PER_S / 1e-6
    assert layers.comm_roofline_pct(ctx) == pytest.approx(want, rel=1e-12)


def test_mfu_and_rest_by_hand():
    ctx = SimpleNamespace(flops_per_round=peaks.F32_FLOPS, rounds=4,
                          call_s=[4.0, 4.0], dtype="float32",
                          spans={"grad": [1.0] * 4, "comm": [0.5] * 2})
    assert layers.mfu_pct(ctx) == pytest.approx(50.0)
    assert layers.rest_ms(ctx) == pytest.approx(1e3 * (8 - 4 - 1) / 4)
    assert layers.grad_ms(ctx) == pytest.approx(1e3)


def test_trace_reduction_by_hand():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 100, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 15, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 28,
           "dur": 24, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 35,
           "dur": 10, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0,
           "dur": 100, "tid": 2}]
    out = trace.summarize(ev)
    # busy [10, 30] + [50, 60] + [95, 100] of the window [0, 100]
    assert out["busy_s"] == pytest.approx(35e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"k1": 10e-6, "k2": 15e-6, "copy": 10e-6, "late": 5e-6})
    # gaps [0, 10] (nothing on the window's thread), [30, 50] (middle 40:
    # inner), [60, 95] (middle 77.5: nothing)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"host (no event)": 45e-6, "aten::inner": 20e-6})
    assert trace.summarize(ev[1:]) == {}


def test_check_gaps_by_hand():
    ref = {"loss": [2.0, 2.0, 2.0],
           "grad": {"a": np.array([1.0, 2.0]), "b": np.array([4.0, 4.0]),
                    "c": np.array([1e-9, 1e-9])},
           "resolution": {"a": 1e-6, "b": 1e-6, "c": 1e-9},
           "size": {"a": 100, "b": 100, "c": 100}}
    ref["change_x"] = ref["change_xt"] = ref["grad"]
    prog = {"loss": [2.002, 2.0, 2.0],
            "grad": {"a": np.array([1.1, 2.0]), "b": np.array([4.0, 4.4]),
                     "c": np.array([1.0, 1.0])}}
    prog["change_x"] = prog["change_xt"] = prog["grad"]
    numbers, where = check.compare(prog, ref)
    # a: 0.1 against the median leaf's 1.0 (worker 0); b: 0.4 / 4.0; c is
    # left out (a = 1: its state reads its step to 1/sqrt(1200) + 1/24)
    assert numbers["first_loss_gap"] == pytest.approx(1e-3)
    assert numbers["grad_gap"] == pytest.approx(0.1)
    assert where["grad_gap"] in ("a", "b") and where["left_out"] == ["c"]
    limits = {"first_loss_gap": 2e-3, "grad_gap": 0.2, "change_gap": 0.2}
    assert check.verdict(numbers, limits)
    assert not check.verdict(numbers, {**limits, "grad_gap": 0.05})
    assert not check.verdict({**numbers, "change_gap": float("nan")},
                             dict.fromkeys(limits, 1.0))


def test_stratified_counts_by_hand():
    from perfbench.streams.schedule import stratified_counts
    rng = np.random.default_rng(0)
    # Poisson(1): P(0) = 0.368, P(<= 1) = 0.736, P(<= 2) = 0.920,
    # P(<= 3) = 0.981; quantiles at 1/6, 1/2, 5/6 and at 0.05, ..., 0.95
    assert sorted(stratified_counts(1.0, 3, rng)) == [0, 1, 2]
    assert sorted(stratified_counts(1.0, 10, rng)) == [0] * 4 + [1] * 3 \
        + [2] * 2 + [3]
    orders = {tuple(stratified_counts(1.0, 10, rng)) for _ in range(5)}
    assert len(orders) > 1
