"""The program's own spans and counters, and their readers.

The port records spans and counters from inside its replay
(``repro_torch.analysis.tracing``): ``replay.call`` over
``replay.compile``, ``replay.pack`` / ``replay.unpack``, one
``replay.comm`` a comm step, one ``replay.mix`` a mixing sweep and one
``replay.tick`` a gradient tick with ``replay.grad``, ``replay.descend``
and ``replay.row`` under it; ``python.gc`` for each collection; the
call's counters (rounds, ticks, comm steps, pairs, comm bytes) in its
``replay.call`` args.  A CUDA tracer adds each span's ``device_ms``.

Each reader takes a run's context and returns a number, or None where the
context holds no program spans (``ctx.program`` absent or None), as every
run of a program without them does.  ``ctx.program`` is::

    {"events": the resolved tracer's events,
     "window": (first, last) host times of the window on the tracer's
               clock, in us,
     "profile": {"launches": n, "rounds": r} of the profiled call, or None}

The window's calls are the top-level ``replay.call`` spans that start in
the window.  Times are a span's ``device_ms``; on the CPU (the tests'
runs, no device) its host duration.

``python3 -m perfbench.program --workload <cell> --seed <n>`` (from the
root of a checkout, ``src`` on ``PYTHONPATH``) runs a cell with a CUDA
tracer active from before set-up on, in three phases on one state: calls
with the tracer off and on in turns (its cost), calls with the tracer on
and the harness's CUDA events around the same ``grad_fn`` and
``FlatGossipEngine.batch`` (how far the two agree), and one call under
``torch.profiler`` with the tracer on (launches, and the device's idle
gaps named by the program's spans).  It prints one JSON line and writes
the events under ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


# ----------------------------------------------------------------- reading
def spans(prog: dict, name: str | None = None) -> list[dict]:
    return [e for e in prog["events"] if e.get("ph") == "X"
            and (name is None or e["name"] == name)]


def span_ms(e: dict) -> float:
    """A span's device time, else (no device) its host time, in ms."""
    return e["args"].get("device_ms", e["dur"] * 1e-3)


def window_calls(prog: dict) -> list[dict]:
    w0, w1 = prog["window"]
    return [e for e in spans(prog, "replay.call")
            if e["args"]["parent"] == 0 and w0 <= e["ts"] < w1]


def _under(prog: dict, calls: list[dict]) -> dict[int, dict]:
    """{span id: span} of every span below one of ``calls``."""
    ids = {c["args"]["id"] for c in calls}
    out = {}
    for e in sorted(spans(prog), key=lambda e: e["args"]["id"]):
        if e["args"]["parent"] in ids:
            ids.add(e["args"]["id"])
            out[e["args"]["id"]] = e
    return out


def per_round_ms(ctx, name: str) -> float | None:
    """Σ time of the window calls' ``name`` spans over their rounds."""
    prog = getattr(ctx, "program", None)
    if not prog:
        return None
    calls = window_calls(prog)
    rounds = sum(c["args"].get("rounds", 0) for c in calls)
    found = [e for e in _under(prog, calls).values() if e["name"] == name]
    if not found or not rounds:
        return None
    return sum(span_ms(e) for e in found) / rounds


def descend_ms(ctx) -> float | None:
    return per_round_ms(ctx, "replay.descend")


def row_ms(ctx) -> float | None:
    return per_round_ms(ctx, "replay.row")


def mix_ms(ctx) -> float | None:
    return per_round_ms(ctx, "replay.mix")


def gc_ms(ctx) -> float | None:
    """Host time of the collections that fell inside the window's calls,
    per round (0 where none did)."""
    prog = getattr(ctx, "program", None)
    if not prog:
        return None
    calls = window_calls(prog)
    rounds = sum(c["args"].get("rounds", 0) for c in calls)
    if not rounds:
        return None
    pauses = sum(e["dur"] for e in spans(prog, "python.gc")
                 if any(c["ts"] <= e["ts"] < c["ts"] + c["dur"]
                        for c in calls))
    return pauses * 1e-3 / rounds


def launches_per_round(ctx) -> float | None:
    prog = getattr(ctx, "program", None)
    prof = prog.get("profile") if prog else None
    if not prof or not prof.get("rounds"):
        return None
    return prof["launches"] / prof["rounds"]


def first_tick_s(ctx) -> float | None:
    """Time of the process's first gradient call, s: the first round of
    set-up, with the first calls into cuDNN, cuBLAS and ``torch.func``."""
    prog = getattr(ctx, "program", None)
    grads = spans(prog, "replay.grad") if prog else []
    if not grads:
        return None
    return span_ms(min(grads, key=lambda e: e["ts"])) * 1e-3


READERS = {"descend_ms": descend_ms, "row_ms": row_ms, "mix_ms": mix_ms,
           "gc_ms": gc_ms, "launches_per_round": launches_per_round,
           "first_tick_s": first_tick_s}


def launches(events: list[dict]) -> dict:
    """Runtime launch calls inside the Chrome trace's ``replay.call``
    range, and the rounds (``replay.tick`` ranges) in it; {} where the
    trace has no ``replay.call``."""
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in full if e.get("name") == "replay.call"
             and e.get("cat") == "user_annotation"]
    if not calls:
        return {}
    c0 = float(calls[0]["ts"])
    c1 = c0 + float(calls[0]["dur"])

    def inside(e):
        return c0 <= float(e["ts"]) <= c1

    return {"launches": sum(1 for e in full if e.get("name") in LAUNCHES
                            and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")
                            and inside(e)),
            "rounds": sum(1 for e in full if e.get("name") == "replay.tick"
                          and e.get("cat") == "user_annotation"
                          and inside(e))}


def span_kernels(events: list[dict], top: int = 5) -> dict:
    """{program span: [device seconds, [[kernel, seconds], ...]]}: each
    device operation of a Chrome trace charged to the innermost program
    range (``replay.*``, ``python.gc``) open when its launch was called."""
    from . import trace
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in full
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(("replay.", "python.gc")))
    called = {e["args"]["correlation"]: float(e["ts"]) for e in full
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ops = sorted((called[e["args"]["correlation"]], e) for e in full
                 if e.get("cat") in trace.DEVICE_CATS
                 and e.get("args", {}).get("correlation") in called)
    out: dict = {}
    stack, i = [], 0
    for t, e in ops:
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        stack = [r for r in stack if r[1] >= t]
        if not stack:
            continue
        total, names = out.setdefault(stack[-1][2], [0.0, {}])
        sec = float(e["dur"]) * 1e-6
        out[stack[-1][2]][0] = total + sec
        names[e["name"][:64]] = names.get(e["name"][:64], 0.0) + sec
    return {k: [v[0], sorted(([n, s] for n, s in v[1].items()),
                             key=lambda ns: -ns[1])[:top]]
            for k, v in out.items()}


# ------------------------------------------------------------ a traced run
def profile_events(fn) -> list[dict]:
    """``fn`` under ``torch.profiler`` inside ``trace.WINDOW``, as
    ``trace.profile`` runs it; the Chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


class GcPauses:
    """Host time of the collections since the last ``take``, s, whether a
    tracer is active or not."""

    def __init__(self):
        self.total, self._t0 = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    def take(self) -> float:
        out, self.total = self.total, 0.0
        return out


def _median(xs):
    return statistics.median(xs) if xs else None


def traced_run(bench, name: str, seed: int, device, pairs: int = 4,
               agree_calls: int = 3) -> dict:
    """The three phases of a traced run (the module's docstring) on one
    cell; returns the report."""
    import torch
    from repro_torch.analysis import SpanTracer
    from repro_torch.core.engine import FlatGossipEngine

    from . import harness, trace
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cell = harness.Cell(bench, name)
    per = cell.wl["rounds_per_call"]
    calls_needed = 2 * pairs + agree_calls + 2
    seconds = calls_needed * per / cell.wl["max_rounds_per_s"]
    tracer = SpanTracer("perfbench", device=device)
    t0 = time.perf_counter()
    with tracer.activate():
        run = harness.build(cell, seed, seconds, device)
    sync()
    setup_s = time.perf_counter() - t0
    sim, state, arrays = run.sim, run.state, run.arrays
    run.state = None
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    r0 = harness.CHECK_ROUNDS
    walls = {"off": [], "on": []}
    gc_s = {"off": [], "on": []}

    def call(simulator, traced):
        nonlocal state, r0
        sched = harness.port_schedule(arrays, r0, r0 + per)
        pauses.take()
        c0 = time.perf_counter()
        if traced:
            with tracer.activate():
                state, _ = simulator.run_schedule(state, sched)
        else:
            state, _ = simulator.run_schedule(state, sched)
        sync()
        wall = time.perf_counter() - c0
        r0 += per
        return wall, pauses.take()

    w0 = tracer.now_us()
    # phase 1: the tracer's cost, calls in turns off, on, on, off, ...
    for i in range(2 * pairs):
        side = "on" if (i % 4) in (1, 2) else "off"
        wall, paused = call(sim, side == "on")
        walls[side].append(wall)
        gc_s[side].append(paused)
    # phase 2: the harness's CUDA events around the same calls
    spans_h = harness.Spans(device)
    wrapped = dataclasses.replace(sim, grad_fn=spans_h.wrap("grad",
                                                            sim.grad_fn))
    orig_batch = FlatGossipEngine.batch
    FlatGossipEngine.batch = spans_h.wrap("comm", orig_batch)
    a0 = tracer.now_us()
    agree_walls = []
    try:
        for _ in range(agree_calls):
            agree_walls.append(call(wrapped, True)[0])
    finally:
        FlatGossipEngine.batch = orig_batch
    w1 = tracer.now_us()
    gc.callbacks.remove(pauses)
    # phase 3: one call under the profiler, the tracer on
    prof = None
    if cuda:
        def one_call():
            with tracer.activate():
                sim.run_schedule(state, harness.port_schedule(arrays, r0,
                                                              r0 + per))
        events = profile_events(one_call)
        prof = {**trace.summarize(events, top=40), **launches(events),
                "span_kernels": span_kernels(events)}
    tracer.resolve()
    prog = {"events": tracer.events, "window": (w0, w1), "profile": prof}
    ctx = SimpleNamespace(program=prog)
    report = {"cell": name, "seed": seed, "setup_s": setup_s,
              "metrics": {k: f(ctx) for k, f in READERS.items()}}
    # the tracer's cost: medians of the call walls, with and without the
    # collections' pauses
    report["overhead"] = {
        side: {"walls": walls[side], "gc_s": gc_s[side],
               "median": _median(walls[side]),
               "median_less_gc": _median([w - g for w, g in
                                          zip(walls[side], gc_s[side])])}
        for side in walls}
    on, off = (report["overhead"][s]["median_less_gc"] for s in ("on", "off"))
    report["overhead"]["pct_less_gc"] = 100.0 * (on / off - 1.0)
    report["overhead"]["pct"] = 100.0 * (
        report["overhead"]["on"]["median"]
        / report["overhead"]["off"]["median"] - 1.0)
    # coverage of each traced call's wall by its replay.call span
    calls = window_calls(prog)
    on_walls = walls["on"] + agree_walls
    report["coverage"] = [{"host": c["dur"] * 1e-6 / w,
                           "device": span_ms(c) * 1e-3 / w}
                          for c, w in zip(calls, on_walls)]
    # the program's spans against the harness's events, phase 2
    agree = {"replay.grad": "grad", "replay.comm": "comm"}
    h = spans_h.seconds()
    phase2 = [c for c in calls if c["ts"] >= a0]
    under = _under(prog, phase2).values()
    report["agreement"] = {}
    for span_name, kind in agree.items():
        mine = [span_ms(e) for e in under if e["name"] == span_name]
        theirs = [s * 1e3 for s in h.get(kind, [])]
        report["agreement"][span_name] = {
            "program_ms": sum(mine) / max(len(mine), 1),
            "harness_ms": sum(theirs) / max(len(theirs), 1),
            "n": [len(mine), len(theirs)]}
    rounds2 = sum(c["args"]["rounds"] for c in phase2)
    rest = sum(agree_walls) - sum(h.get("grad", [])) - sum(h.get("comm", []))
    report["rest_ms"] = 1e3 * rest / rounds2
    # every span's time per round in the window, by name, and the
    # counters of the window's calls
    by_name = {}
    for e in _under(prog, calls).values():
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + span_ms(e)
    rounds = sum(c["args"]["rounds"] for c in calls)
    report["per_round_ms"] = {k: v / rounds for k, v in by_name.items()}
    report["call_ms_per_round"] = sum(span_ms(c) for c in calls) / rounds
    report["counters"] = [{k: c["args"][k] for k in
                           ("rounds", "ticks", "steps", "pairs",
                            "comm_bytes")} for c in calls]
    report["kernels"] = {e["name"]: e["args"] for e in tracer.events
                         if e.get("ph") == "C"
                         and e["name"].startswith("kernels.")}
    report["setup_spans_s"] = {}
    for e in spans(prog):
        if e["ts"] < w0 and e["args"]["parent"] == 0:
            report["setup_spans_s"][e["name"]] = \
                report["setup_spans_s"].get(e["name"], 0.0) + e["dur"] * 1e-6
    if prof:
        report["profile"] = {k: prof.get(k) for k in
                             ("busy_s", "window_s", "idle_gaps", "launches",
                              "rounds", "span_kernels")}
    return report, tracer


def main(argv=None) -> int:
    import torch

    from . import harness, spec
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    if not torch.cuda.is_available():
        print("perfbench.program: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = harness.card_line()
    report, tracer = traced_run(spec.Bench(root), args.workload, args.seed,
                                torch.device("cuda"), args.pairs)
    report["card"] = card
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tracer.write(str(out / f"program_{args.workload}_{args.seed}.json"))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
