"""The MoE layer's spans and counter, and their readers, beside
``program.py``'s.

The port's dropless MoE layer (``kernels/moe_experts/ops.py``) records a
``moe.route`` span (router, selection, the routing tables), ``moe.experts``
(the grouped gate, up and down products), ``moe.combine`` (the gated sum
a token) and ``moe.experts_bwd`` (the backward's six launches), and one
``moe`` counter a layer call: held rows, the largest (worker, expert)
group, the groups, the products' FLOPs (18 d f a row, forward and
backward) and their least bytes.  The backward runs on autograd's device
thread, where no replay span is open, so a span is charged to the window's
calls by its time, not by its parent.

  * ``moe_ms``: the device time of every ``moe.*`` span in the window's
    calls, per round;
  * ``experts_roofline_pct``: the least time of the counters' work (the
    larger of FLOPs at ``peaks.F32_FLOPS`` and bytes at the HBM's rate,
    counter by counter) over the device time of the ``moe.experts`` and
    ``moe.experts_bwd`` spans.

Each returns None where the context holds no program spans, or none of
these, as every run of a program without the MoE layer does.

``python3 -m perfbench.program_moe --workload <cell> --seed <n>`` (from
the root of a checkout, ``src`` on ``PYTHONPATH``) runs a cell's calls
with a CUDA tracer active, one more under ``torch.profiler``, and prints
one JSON line: the readers, the device time charged to each ``moe.*``
range by kernel, and the host synchronisations and copies called inside
the ``moe.*`` ranges and inside ``replay.call``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import peaks
from .program import (launches, profile_events, span_kernels, span_ms,
                      window_calls)

SPANS = ("moe.route", "moe.experts", "moe.combine", "moe.experts_bwd")
PRODUCTS = ("moe.experts", "moe.experts_bwd")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def _in_calls(prog: dict) -> tuple[list[dict], list[dict], int]:
    """(the window's calls, every event that starts inside one, their
    rounds)."""
    calls = window_calls(prog)
    inside = [e for e in prog["events"] if e.get("ph") in ("X", "C")
              and any(c["ts"] <= e["ts"] < c["ts"] + c["dur"]
                      for c in calls)]
    return calls, inside, sum(c["args"].get("rounds", 0) for c in calls)


def moe_ms(ctx) -> float | None:
    prog = getattr(ctx, "program", None)
    if not prog:
        return None
    _, inside, rounds = _in_calls(prog)
    found = [e for e in inside if e["ph"] == "X" and e["name"] in SPANS]
    if not found or not rounds:
        return None
    return sum(span_ms(e) for e in found) / rounds


def experts_roofline_pct(ctx) -> float | None:
    prog = getattr(ctx, "program", None)
    if not prog:
        return None
    _, inside, _ = _in_calls(prog)
    ms = sum(span_ms(e) for e in inside
             if e["ph"] == "X" and e["name"] in PRODUCTS)
    least = sum(max(c["args"]["flops"] / peaks.F32_FLOPS,
                    c["args"]["bytes"] / peaks.HBM_BYTES_PER_S)
                for c in inside if c["ph"] == "C" and c["name"] == "moe"
                and "flops" in c["args"])
    if not ms or not least:
        return None
    return 100.0 * least / (ms * 1e-3)


READERS = {"moe_ms": moe_ms, "experts_roofline_pct": experts_roofline_pct}


def host_syncs(events: list[dict]) -> dict:
    """{range: {call: count}} of the synchronising and copying runtime
    calls made inside each ``moe.*`` range and inside ``replay.call`` of a
    Chrome trace; a copy is named with its device side's kind (``Memcpy
    DtoD``, ``Memcpy DtoH``, ...) where the trace has it."""
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = [e for e in full if e.get("cat") == "user_annotation"
              and (e["name"] in SPANS or e["name"] == "replay.call")]
    kind = {e["args"]["correlation"]: e["name"].split(" (")[0]
            for e in full if e.get("cat") == "gpu_memcpy"
            and "correlation" in e.get("args", {})}
    out: dict = {}
    for e in full:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") \
                or e["name"] not in SYNCS:
            continue
        name = e["name"]
        corr = e.get("args", {}).get("correlation")
        if corr in kind:
            name = f"{name}: {kind[corr]}"
        t = float(e["ts"])
        for r in ranges:
            if float(r["ts"]) <= t <= float(r["ts"]) + float(r["dur"]):
                row = out.setdefault(r["name"], {})
                row[name] = row.get(name, 0) + 1
    return out


def traced_calls(bench, name: str, seed: int, device, calls: int = 3
                 ) -> dict:
    """``calls`` calls of the cell with a tracer active, then one under
    the profiler; the report."""
    import torch
    from repro_torch.analysis import SpanTracer

    from . import harness
    cell = harness.Cell(bench, name)
    per = cell.wl["rounds_per_call"]
    run = harness.build(cell, seed, (calls + 2) * per
                        / cell.wl["max_rounds_per_s"], device)
    sim, state, arrays = run.sim, run.state, run.arrays
    run.state = None
    tracer = SpanTracer("perfbench", device=device)
    r0, walls = harness.CHECK_ROUNDS, []
    w0 = tracer.now_us()
    for _ in range(calls):
        c0 = time.perf_counter()
        with tracer.activate():
            state, _ = sim.run_schedule(state, harness.port_schedule(
                arrays, r0, r0 + per))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - c0)
        r0 += per
    w1 = tracer.now_us()

    def one_call():
        with tracer.activate():
            sim.run_schedule(state, harness.port_schedule(arrays, r0,
                                                          r0 + per))
    events = profile_events(one_call)
    tracer.resolve()
    prog = {"events": tracer.events, "window": (w0, w1),
            "profile": launches(events)}
    ctx = SimpleNamespace(program=prog)
    renamed = [dict(e, name="replay." + e["name"])
               if e.get("cat") == "user_annotation"
               and e.get("name") in SPANS else e for e in events]
    counters = [e["args"] for e in tracer.events
                if e.get("ph") == "C" and e["name"] == "moe"
                and w0 <= e["ts"] < w1]
    _, inside, rounds = _in_calls(prog)
    return {"cell": name, "seed": seed, "call_s": walls,
            "metrics": {k: f(ctx) for k, f in READERS.items()},
            "per_round_ms": {
                s: sum(span_ms(e) for e in inside
                       if e["ph"] == "X" and e["name"] == s) / rounds
                for s in SPANS},
            "counters": {"n": len(counters),
                         "rows_mean": sum(c["rows"] for c in counters)
                         / max(len(counters), 1),
                         "largest": max((c["largest"] for c in counters),
                                        default=None),
                         "groups": counters[0]["groups"] if counters
                         else None},
            "span_kernels": {k[len("replay."):]: v for k, v in
                             span_kernels(renamed).items()
                             if k[len("replay."):] in SPANS},
            "host_syncs": host_syncs(events),
            "launches": launches(events)}


def main(argv=None) -> int:
    import torch

    from . import harness, spec
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.program_moe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.program_moe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent.parent
    report = traced_calls(spec.Bench(root), args.workload, args.seed,
                          torch.device("cuda"), args.calls)
    report["card"] = harness.card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
