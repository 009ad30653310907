"""The replay's own spans and counters (``analysis/tracing.py`` recorded to
from ``core/simulator.py``).

The contracts under test, on the clean engine path (``run_coalesced``)
and its channel twin (``run_channel_coalesced``: stale reads, sign-flipped
edges, drops and the trim rule):

  * tracing changes nothing: with a tracer active the replay returns the
    state and the ``SimTrace`` bit for bit those of a run without one;
  * the span tree: one ``replay.call`` over one ``replay.compile``,
    ``replay.pack`` and ``replay.unpack``; each gradient tick one
    ``replay.tick`` whose children are exactly ``replay.grad``,
    ``replay.descend`` and ``replay.row``; one ``replay.comm`` a comm step
    and one ``replay.mix`` a mixing sweep (the prologue and one a tick);
    parent ids match the nesting in time;
  * the call's counters equal the counts of the compiled schedule;
  * off is off: no tracer active, no event, no profiler range and no
    ``gc`` callback left behind;
  * under ``torch.profiler`` the program's spans are ``user_annotation``
    events nested in ``replay.call``;
  * collections are ``python.gc`` spans under the span they interrupted.
"""
import gc
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import SpanTracer, tracing, validate_trace
from repro_torch.core import (ByzantineEdges, ChannelModel, DelayProcess,
                              Simulator, make_schedule, params_from_graph,
                              ring_graph)
from repro_torch.core.events import coalesce_schedule, coalesced_stream

N, DIM, ROUNDS, GAMMA = 6, 16, 8, 0.05
B = np.random.default_rng(3).normal(size=(N, DIM)).astype(np.float32)
REPLAY = ("replay.call", "replay.compile", "replay.pack", "replay.unpack",
          "replay.comm", "replay.tick", "replay.grad", "replay.descend",
          "replay.row", "replay.mix")


def grad_fn(x, generator, worker_ids):
    b = torch.from_numpy(B)[worker_ids]
    noise = torch.randn(x.shape, generator=generator)
    return 0.5 * ((x - b) ** 2).sum(dim=1), x - b + 0.01 * noise


def _case(flavour):
    """(simulator, schedule) of the clean or the channel engine path."""
    g = ring_graph(N)
    sched = make_schedule(g, ROUNDS, comms_per_grad=1.5, seed=4)
    kw = {}
    if flavour == "channel_coalesced":
        sched = ChannelModel(delay=DelayProcess(horizon=2, prob=0.6),
                             adversary=ByzantineEdges(g.edges[:2],
                                                      "sign_flip"),
                             drop_prob=0.1).apply(sched, seed=4)
        kw = dict(robust_clip=0.5)
    return Simulator(grad_fn, params_from_graph(g), GAMMA, device="cpu",
                     **kw), sched


def _run(flavour):
    sim, sched = _case(flavour)
    state = sim.init(torch.zeros(DIM), N, torch.Generator().manual_seed(0))
    return sim.run_schedule(state, sched)


def _traced(flavour):
    tracer = SpanTracer("test")
    with tracer.activate():
        out = _run(flavour)
    return out, tracer


def _spans(tracer, name=None):
    return [e for e in tracer.events if e["ph"] == "X"
            and (name is None or e["name"] == name)]


FLAVOURS = ["coalesced", "channel_coalesced"]


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_tracing_leaves_replay_bitwise(flavour):
    plain_state, plain_trace = _run(flavour)
    (state, trace), tracer = _traced(flavour)
    for a, b in ((plain_state.x, state.x),
                 (plain_state.x_tilde, state.x_tilde),
                 (plain_state.t_last, state.t_last)):
        assert torch.equal(a, b)
    for name in ("loss", "consensus", "mean_param_norm"):
        assert torch.equal(getattr(plain_trace, name), getattr(trace, name))
    assert _spans(tracer, "replay.call")[0]["args"]["flavour"] == flavour


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_span_tree(flavour):
    _, tracer = _traced(flavour)
    spans = [e for e in _spans(tracer) if e["name"] != "python.gc"]
    by_id = {e["args"]["id"]: e for e in spans}
    assert len(by_id) == len(spans)
    assert {e["name"] for e in spans} == set(REPLAY)

    def children(e):
        return [c for c in spans if c["args"]["parent"] == e["args"]["id"]]

    for e in spans:
        parent = by_id.get(e["args"]["parent"])
        if parent is None:
            assert e["name"] == "replay.call" and e["args"]["parent"] == 0
            continue
        # a child lies inside its parent on the host clock
        assert parent["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    (call,) = _spans(tracer, "replay.call")
    counts = {}
    for c in children(call):
        counts[c["name"]] = counts.get(c["name"], 0) + 1
    ticks = _spans(tracer, "replay.tick")
    assert len(ticks) == ROUNDS
    assert counts == {"replay.compile": 1, "replay.pack": 1,
                      "replay.unpack": 1, "replay.tick": ROUNDS,
                      "replay.mix": ROUNDS + 1,
                      "replay.comm": call["args"]["steps"]}
    for tick in ticks:
        assert [c["name"] for c in children(tick)] == [
            "replay.grad", "replay.descend", "replay.row"]
    assert sum(e["args"]["pairs"] for e in _spans(tracer, "replay.comm")) \
        == call["args"]["pairs"]
    validate_trace(json.loads(json.dumps(tracer.to_dict())))


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_counters_match_schedule(flavour):
    _, tracer = _traced(flavour)
    sim, sched = _case(flavour)
    stream = coalesced_stream(coalesce_schedule(sched),
                              np.zeros(N, np.float32))
    comm = ~np.asarray(stream.is_grad)
    partners = np.asarray(stream.partners)[comm]
    want = {"rounds": ROUNDS, "ticks": ROUNDS, "steps": int(comm.sum()),
            "pairs": int((partners != np.arange(N)).sum()),
            # x and x~ of every worker read and written once, f32, D 128
            "comm_bytes": int(comm.sum()) * 4 * N * 128 * 4}
    (sample,) = [e for e in tracer.events if e["ph"] == "C"]
    (call,) = _spans(tracer, "replay.call")
    assert sample["name"] == "replay"
    assert sample["parent"] == call["args"]["id"]
    assert sample["args"] == {k: float(v) for k, v in want.items()}
    assert {k: call["args"][k] for k in want} == want
    assert want["pairs"] > 0 and want["steps"] > 0


def test_off_records_nothing():
    callbacks = list(gc.callbacks)
    idle = SpanTracer("idle")
    before = list(idle.events)
    assert tracing.active() is None
    assert tracing.span("replay.tick") is tracing.span("replay.row")
    tracing.count("replay", rounds=1)
    _run("coalesced")
    assert idle.events == before and not idle._pending
    assert gc.callbacks == callbacks
    outer, inner = SpanTracer("outer"), SpanTracer("inner")
    with outer.activate():
        with inner.activate():
            assert tracing.active() is inner
            assert len(gc.callbacks) == len(callbacks) + 2
        assert tracing.active() is outer
    assert tracing.active() is None and gc.callbacks == callbacks


def test_profiler_sees_program_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tracer = SpanTracer("test")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.activate():
            _run("coalesced")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("replay.")]
    (call,) = [e for e in events if e["name"] == "replay.call"]
    c0, c1 = call["ts"], call["ts"] + call["dur"]
    inside = [e for e in events if e is not call]
    assert {e["name"] for e in inside} == set(REPLAY) - {"replay.call"}
    assert all(c0 <= e["ts"] and e["ts"] + e["dur"] <= c1 for e in inside)
    assert len([e for e in inside if e["name"] == "replay.tick"]) == ROUNDS


def test_collections_are_spans_under_the_open_span():
    tracer = SpanTracer("test")
    with tracer.activate():
        with tracing.span("outer"):
            garbage = [[]]
            garbage[0].append(garbage)
            del garbage
            gc.collect()
        tracing.count("kernels.load", mixing_gossip_stacked=1)
    (outer,) = _spans(tracer, "outer")
    collections = _spans(tracer, "python.gc")
    assert collections
    full = [e for e in collections if e["args"]["generation"] == 2]
    assert full and full[-1]["args"]["parent"] == outer["args"]["id"]
    assert full[-1]["args"]["collected"] >= 1
    (sample,) = [e for e in tracer.events if e["ph"] == "C"]
    assert sample["parent"] == 0 and sample["name"] == "kernels.load"
    assert tracer.resolve() is tracer


@pytest.mark.gpu
def test_cuda_tracer_records_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    dev = torch.device("cuda")
    tracer = SpanTracer("test", device=dev)
    a = torch.randn(2048, 2048, device=dev)
    with tracer.activate():
        with tracing.span("outer"):
            for _ in range(4):
                with tracing.span("inner"):
                    a = a @ a / 2048 ** 0.5
    tracer.resolve()
    spans = _spans(tracer)
    assert all(e["args"]["device_ms"] > 0 for e in spans
               if e["name"] != "python.gc")
    (outer,) = _spans(tracer, "outer")
    inner = sum(e["args"]["device_ms"] for e in _spans(tracer, "inner"))
    assert inner <= outer["args"]["device_ms"] * 1.001


def test_device_counter_reads_its_tensors_at_resolve():
    tracer = SpanTracer("test")
    rows = torch.tensor(3)
    tracing.count_device("moe", rows=rows)          # none active: nothing
    with tracer.activate():
        with tracing.span("outer"):
            tracing.count_device("moe", rows=rows, groups=4)
    (sample,) = [e for e in tracer.events if e["ph"] == "C"]
    (outer,) = _spans(tracer, "outer")
    assert sample["parent"] == outer["args"]["id"] and sample["args"] == {}
    rows += 2                  # read at resolve, never while recording
    tracer.resolve()
    assert sample["args"] == {"rows": 5.0, "groups": 4.0}
    validate_trace(tracer.to_dict())
