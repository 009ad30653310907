"""Whole runs through the harness on the CPU at a tiny size, past its look
for a card: cells added as files in a temporary copy of the benchmark
(``conftest.tiny_bench``) run with no other file edited, print the
contract's result line, and come out correct; with the timed path broken
underneath (the gradient step leaving the state unchanged, half of each
worker's batch left out, the averaging between workers left out),
``correct`` comes out false."""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import harness
from perfbench.conftest import LM, RESNET
from perfbench.models import resnet

CPU = torch.device("cpu")
SEED = 2 ** 33 + 12345


def run(bench, cell, traced=False):
    result, numbers, limits = harness.run_cell(bench, cell, SEED, 0.3,
                                               traced, CPU,
                                               time.perf_counter())
    return json.loads(harness.finish(result, numbers, limits))


@pytest.mark.parametrize("cell", [RESNET, LM])
@pytest.mark.parametrize("traced", [False, True])
def test_added_cell_runs_and_is_correct(tiny_bench, cell, traced, capsys):
    out = run(tiny_bench, cell, traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["attempted"] % 2 == 0
    names = {m["name"] for m in (tiny_bench.per_layer(cell) if traced
                                 else tiny_bench.end_to_end(cell))}
    if traced:
        # no device trace on the CPU: the idle share is left out
        names = {n for n in names if not n.startswith("device_idle")}
    assert set(out["metrics"]) == names
    # no device memory on the CPU either
    assert all(v["value"] > 0 for k, v in out["metrics"].items()
               if k != "peak_mem_gib")
    err = capsys.readouterr().err.strip().splitlines()
    assert [line.split()[1] for line in err[-3:]] == list(out["check"])


def _unchanged(monkeypatch):
    from repro_torch.core.simulator import Simulator
    monkeypatch.setattr(Simulator, "_descend",
                        staticmethod(lambda eng, bx, bxt, *a: (bx, bxt)))


def _half_batch(monkeypatch):
    program = resnet.program_grad_fn

    def broken(cfg, stream):
        fn = program(cfg, stream)

        def grad_fn(x, generator, ids):
            batch = fn.draw(generator, ids.shape[0])
            half = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
            return fn.apply(x, half, ids)
        return grad_fn
    monkeypatch.setattr(resnet, "program_grad_fn", broken)


def _no_exchange(monkeypatch):
    from repro_torch.core.engine import FlatGossipEngine
    batch = FlatGossipEngine.batch

    def no_partner(self, bx, bxt, partner, dt_next):
        return batch(self, bx, bxt, torch.arange(bx.shape[0]), dt_next)
    monkeypatch.setattr(FlatGossipEngine, "batch", no_partner)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(tiny_bench, fault, monkeypatch):
    fault(monkeypatch)
    out = run(tiny_bench, RESNET)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["check"].values())
