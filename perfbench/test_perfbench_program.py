"""The readers of the program's own spans (``program.py``): each reads its
number from a hand-made context and says nothing (None) where the run
holds no program spans; ``launches`` counts runtime launches inside
``replay.call`` only; a traced run of a tiny cell on the CPU yields every
reader's number but the profiled call's, and leaves the harness as it
found it."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, program, trace
from perfbench.conftest import LM, RESNET

CPU = torch.device("cpu")
SEED = 2 ** 33 + 777


def _span(name, sid, parent, ts, dur, **args):
    return {"ph": "X", "name": name, "pid": 1, "tid": 1, "ts": ts,
            "dur": dur, "args": {"id": sid, "parent": parent, **args}}


def _program():
    """A set-up call (before the window) and two window calls of 2 rounds
    each; device times in ms, host times in us."""
    ev = [_span("replay.call", 1, 0, 0, 100, rounds=1, device_ms=0.2),
          _span("replay.tick", 2, 1, 10, 80, device_ms=0.1),
          _span("replay.grad", 3, 2, 10, 50, device_ms=5000.0),
          _span("replay.descend", 4, 2, 60, 10, device_ms=99.0)]
    sid = 5
    for k, t0 in enumerate((1000, 2000)):
        call = sid
        ev.append(_span("replay.call", call, 0, t0, 500, rounds=2,
                        device_ms=6.0))
        sid += 1
        for r in range(2):
            tick = sid
            ev.append(_span("replay.tick", tick, call, t0 + 100 * r, 90,
                            device_ms=3.0))
            for name, ms in (("replay.grad", 2.0), ("replay.descend", 0.5),
                             ("replay.row", 0.25)):
                sid += 1
                ev.append(_span(name, sid, tick, t0 + 100 * r, 10,
                                device_ms=ms))
            sid += 1
            ev.append(_span("replay.mix", sid, call, t0 + 100 * r + 95, 2,
                            device_ms=0.125 * (k + 1)))
            sid += 1
    # one pause inside a window call, one between calls
    ev.append(_span("python.gc", sid, call, 2300, 4000, generation=2,
                    collected=9))
    ev.append(_span("python.gc", sid + 1, 0, 2900, 7000, generation=2,
                    collected=1))
    return {"events": ev, "window": (900, 2600),
            "profile": {"launches": 300, "rounds": 4}}


def test_readers_read_the_window():
    ctx = SimpleNamespace(program=_program())
    got = {k: f(ctx) for k, f in program.READERS.items()}
    assert got == {"descend_ms": 0.5, "row_ms": 0.25,
                   # two mixes 0.125, two 0.25 over 4 rounds
                   "mix_ms": 0.1875,
                   # 4 ms of the first pause over 4 rounds; the second
                   # fell between calls
                   "gc_ms": 1.0, "launches_per_round": 75.0,
                   # the set-up's first gradient call
                   "first_tick_s": 5.0}


@pytest.mark.parametrize("ctx", [
    SimpleNamespace(), SimpleNamespace(program=None),
    SimpleNamespace(program={"events": [], "window": (0, 1),
                             "profile": None})],
    ids=["no field", "none", "no spans"])
def test_readers_say_nothing_without_program_spans(ctx):
    assert {k: f(ctx) for k, f in program.READERS.items()} == dict.fromkeys(
        program.READERS)


def test_launches_inside_replay_call_only():
    def ev(name, cat, ts, dur=1.0):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1}
    events = [ev(trace.WINDOW, "user_annotation", 0, 1000),
              ev("replay.call", "user_annotation", 100, 500),
              ev("cudaLaunchKernel", "cuda_runtime", 50),
              ev("cudaLaunchKernel", "cuda_runtime", 150),
              ev("cudaLaunchKernelExC", "cuda_runtime", 200),
              ev("cuLaunchKernel", "cuda_driver", 300),
              ev("cudaMemcpyAsync", "cuda_runtime", 310),
              ev("replay.tick", "user_annotation", 120, 100),
              ev("replay.tick", "user_annotation", 320, 100),
              ev("cudaLaunchKernel", "cuda_runtime", 700),
              ev("some_kernel", "kernel", 160, 30),
              {"ph": "M", "name": "process_name", "pid": 1, "tid": 0}]
    assert program.launches(events) == {"launches": 3, "rounds": 2}
    assert program.launches(events[:1] + events[2:]) == {}
    # the summary the harness reads keeps its keys
    assert set(trace.summarize(events)) == {"busy_s", "window_s",
                                            "device_ops", "idle_gaps"}


def test_device_operations_charged_to_the_innermost_span():
    def ev(name, cat, ts, dur=1.0, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
             "pid": 1, "tid": 1}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [ev("replay.tick", "user_annotation", 100, 500),
              ev("replay.descend", "user_annotation", 200, 100),
              ev("cudaLaunchKernel", "cuda_runtime", 150, corr=1),
              ev("cudaLaunchKernel", "cuda_runtime", 250, corr=2),
              ev("cudaLaunchKernel", "cuda_runtime", 260, corr=3),
              ev("cudaLaunchKernel", "cuda_runtime", 50, corr=4),
              ev("add", "kernel", 900, 4.0, corr=2),
              ev("mul", "kernel", 950, 2.0, corr=3),
              ev("add", "kernel", 700, 8.0, corr=1),
              ev("fill", "kernel", 60, 16.0, corr=4)]
    assert program.span_kernels(events) == {
        "replay.tick": [8e-6, [["add", 8e-6]]],
        "replay.descend": [6e-6, [["add", 4e-6], ["mul", 2e-6]]]}


@pytest.mark.parametrize("cell", [RESNET, LM])
def test_traced_cpu_run_yields_the_readers_numbers(tiny_bench, cell):
    from repro_torch.analysis import tracing
    from repro_torch.core.engine import FlatGossipEngine
    batch, callbacks = FlatGossipEngine.batch, list(gc.callbacks)
    report, tracer = program.traced_run(tiny_bench, cell, SEED, CPU,
                                        pairs=1, agree_calls=2)
    assert tracing.active() is None and gc.callbacks == callbacks
    assert FlatGossipEngine.batch is batch
    m = report["metrics"]
    # no profiled call on the CPU
    assert m.pop("launches_per_round") is None
    assert all(v is not None and v >= 0 for v in m.values()), m
    assert m["descend_ms"] > 0 and m["first_tick_s"] > 0
    # one traced call of phase 1 and the two of phase 2, each of 2 rounds
    assert [c["rounds"] for c in report["counters"]] == [2, 2, 2]
    assert all(c["ticks"] == 2 and c["comm_bytes"] > 0
               for c in report["counters"])
    steps = sum(c["steps"] for c in report["counters"][1:])
    grad, comm = (report["agreement"][k]["n"]
                  for k in ("replay.grad", "replay.comm"))
    assert grad == [4, 4] and comm == [steps, steps]
    assert len(report["overhead"]["on"]["walls"]) == 1
    assert len(report["overhead"]["off"]["walls"]) == 1
    assert len(report["coverage"]) == 3


def test_harness_run_unchanged_by_a_traced_run(tiny_bench):
    """The harness's own traced run reports the metrics it always did: no
    tracer is active there, so the program's spans stay silent."""
    program.traced_run(tiny_bench, RESNET, SEED, CPU, pairs=1,
                       agree_calls=1)
    result, _, _ = harness.run_cell(tiny_bench, RESNET, SEED, 0.3, True,
                                    CPU, time.perf_counter())
    assert set(result["metrics"]) == {
        m["name"] for m in tiny_bench.per_layer(RESNET)
        if not m["name"].startswith("device_idle")}
