"""BENCHMARK.json and the files it names: each configuration, cell and
metric loads by the name the benchmark gives it, and the file keeps the
contract's shapes."""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import pytest

from perfbench import check, spec
from perfbench.conftest import ROOT

BENCH = spec.Bench(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH.spec) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert BENCH.spec["paths"] == ["perfbench"]
    assert 1 <= BENCH.spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH.spec["configs"],
                         ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    data = BENCH.config(cfg["name"])
    assert NAME.match(cfg["name"])
    assert cfg["file"].startswith("perfbench/configs/")
    assert data["reduced"] == cfg["reduced"]
    assert spec.part("models", data["arch"]).WORK_UNIT in ("images",
                                                           "tokens")
    spec.part("reference", data["arch"])


@pytest.mark.parametrize("cell", BENCH.spec["workloads"],
                         ids=lambda c: c["name"])
def test_cell_loads_by_name(cell):
    wl = BENCH.workload(cell["name"])
    assert wl["config"] == cell["config"]
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    spec.part("streams", wl["stream"]["kind"])
    assert tuple(wl["check"]) == check.NAMES
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in BENCH.end_to_end(cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(cell["name"])


@pytest.mark.parametrize("metric",
                         BENCH.spec["end_to_end"] + BENCH.spec["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(BENCH.reader(metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"]
                                   for m in BENCH.spec["end_to_end"]}
        for cell in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in BENCH.end_to_end(cell)}


def test_readers_say_nothing_where_nothing_was_read():
    ctx = SimpleNamespace(unit="images", work=512, rounds=1, call_s=[0.5],
                          setup_s=3.0, peak_bytes=2 ** 30, workers=16,
                          d_real=10, elem_bytes=4, flops_per_round=1e12,
                          dtype="float32", spans={}, trace=None)
    assert BENCH.reader("images_per_s")(ctx) == 1024.0
    assert BENCH.reader("tokens_per_s")(ctx) is None
    assert BENCH.reader("peak_mem_gib")(ctx) == 1.0
    for name in ("grad_ms.resnet", "comm_roofline_pct.resnet",
                 "rest_ms.resnet", "device_idle_pct.resnet"):
        assert BENCH.reader(name)(ctx) is None


def test_cells_of_a_metric_listed_by_name():
    per_cell = {c["name"]: {m["name"] for m in BENCH.per_layer(c["name"])}
                for c in BENCH.spec["workloads"]}
    assert per_cell["resnet18_cifar.ring16_b32"] == {
        f"{m}.resnet" for m in ("grad_ms", "comm_roofline_pct", "rest_ms",
                                "mfu_pct", "device_idle_pct")}
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == BENCH.spec
