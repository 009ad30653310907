"""One run of one cell: set-up, the measured window, the traced call, the
output check, and the result line.

The window drives the port's training replay, ``Simulator.run_schedule``
on its flat-buffer engine (a clean schedule: ``run_coalesced``, one
``mixing_gossip_stacked`` launch a comm step, a batched gradient tick a
round).  Set-up makes the weights, the streams and the whole event
schedule from the seed, builds the port's ``Simulator`` and its state, and
drives that state through the first three rounds: the output check's
steps and the warm-up in one.  The window then makes back-to-back calls of
``rounds_per_call`` rounds on the same state, the events continuing in
simulated time, the card synchronised at each call's end, until
``--seconds`` have passed.  With ``--trace 1`` CUDA events wrap the
``grad_fn`` and ``FlatGossipEngine.batch``, and after the window one more
call runs under ``torch.profiler``.  Once the window has closed and the
program's state is freed, the reference replays the first three rounds
(``reference/replay.py``) and ``check.py`` compares.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, spec, trace, tree
from .reference import replay as ref_replay
from .streams import SCHEDULE, derive
from .streams import schedule as schedule_gen

CHECK_ROUNDS = 3
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What the metric readers read (``metrics/*.py``, ``layers.py``)."""
    unit: str
    work: int
    rounds: int
    call_s: list
    setup_s: float
    peak_bytes: int
    workers: int
    d_real: int
    elem_bytes: int
    flops_per_round: float
    dtype: str
    spans: dict
    trace: dict | None


class Spans:
    """Device-time spans around calls into the program: CUDA event pairs
    on the card, read once the window has closed; the host clock on the
    CPU (the tests' runs)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: dict[str, list] = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, kind: str, fn):
        def call(*args, **kw):
            start = self._mark()
            out = fn(*args, **kw)
            self.marks.setdefault(kind, []).append((start, self._mark()))
            return out
        return call

    def seconds(self) -> dict[str, list[float]]:
        return {k: [s.elapsed_time(e) * 1e-3 if self.cuda else e - s
                    for s, e in v] for k, v in self.marks.items()}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


class Cell:
    """A cell's pieces: its configuration, traffic, model and stream."""

    def __init__(self, bench: spec.Bench, name: str):
        self.name = name
        self.wl = bench.workload(name)
        self.cfg = bench.config(self.wl["config"])
        self.arch = spec.part("models", self.cfg["arch"])
        self.reference = spec.part("reference", self.cfg["arch"])
        self.stream_mod = spec.part("streams", self.wl["stream"]["kind"])
        self.traffic = self.wl["traffic"]

    def schedule(self, seed: int, seconds: float) -> dict:
        """The whole event schedule of a run, made in set-up: the check's
        rounds, enough calls for ``seconds`` at ``max_rounds_per_s``, and
        one call for the trace.  Each block (the check's rounds, each
        call) holds the same event counts for every seed, in another
        order (``schedule_gen.stratified_counts``)."""
        per = self.wl["rounds_per_call"]
        calls = math.ceil(seconds * self.wl["max_rounds_per_s"] / per) + 1
        rng = np.random.default_rng(derive(seed, SCHEDULE))
        t = self.traffic
        lam = t["comms_per_grad"]
        counts = np.concatenate(
            [schedule_gen.stratified_counts(lam, CHECK_ROUNDS, rng)]
            + [schedule_gen.stratified_counts(lam, per, rng)
               for _ in range(calls)])
        return schedule_gen.sample(t["graph"], t["workers"], len(counts),
                                   lam, rng, counts)


def port_schedule(arrays: dict, start: int, stop: int):
    from repro_torch.core.events import Schedule
    a = schedule_gen.rounds_slice(arrays, start, stop)
    return Schedule(a["partners"], a["event_times"], a["event_mask"],
                    a["grad_times"])


def leaf_norms(x, x0, scale: float = 1.0) -> dict[str, np.ndarray]:
    """{path: (W,) float64 norms of (x[w] - x0) * scale} of a stacked
    state ``x`` against the unstacked ``x0``, worker by worker."""
    ref = dict(tree.leaves(x0))
    return {p: np.array([float(torch.linalg.vector_norm(
                (a[w] - ref[p]).double())) * scale
                for w in range(a.shape[0])])
            for p, a in tree.leaves(x)}


@dataclasses.dataclass
class Program:
    """The port's replay as set-up leaves it: the simulator, its state
    after the check's rounds, the whole schedule and the program's side of
    the output check."""
    sim: object
    state: object
    arrays: dict
    stream: object
    prog: dict
    d_real: int
    elem_bytes: int
    marks: tuple          # host clock at the first check call and after


def build(cell: Cell, seed: int, seconds: float, device: torch.device,
          spans: Spans | None = None) -> Program:
    """Set-up: the weights, the streams and the whole schedule from the
    seed, the port's ``Simulator`` and its state, driven through the
    check's rounds: one tick alone (its gradient is (x0 - x1) / gamma),
    then two more; the weights are made again from the seed to read the
    changes.  ``spans`` wraps the ``grad_fn``."""
    from repro_torch.core.a2cid2 import params_from_graph
    from repro_torch.core.graphs import build_graph
    from repro_torch.core.simulator import Simulator

    cfg, t = cell.cfg, cell.traffic
    stream = cell.stream_mod.Stream(cfg, cell.wl, seed, device)
    grad_fn = cell.arch.program_grad_fn(cfg, stream)
    if spans is not None:
        grad_fn = spans.wrap("grad", grad_fn)
    arrays = cell.schedule(seed, seconds)
    gamma = cell.wl["step_size"]
    sim = Simulator(grad_fn, params_from_graph(
        build_graph(t["graph"], t["workers"]), t["accelerated"]), gamma,
        device=device)
    x0 = cell.arch.init_params(cfg, seed, device)
    d_real = sum(a.numel() for _, a in tree.leaves(x0))
    elem_bytes = tree.leaves(x0)[0][1].element_size()
    state = sim.init(x0, t["workers"], torch.Generator(device=device))
    del x0
    first = time.perf_counter()
    state, tr1 = sim.run_schedule(state, port_schedule(arrays, 0, 1))
    x0 = cell.arch.init_params(cfg, seed, device)
    prog = {"grad": leaf_norms(state.x, x0, 1.0 / gamma)}
    state, tr2 = sim.run_schedule(state, port_schedule(arrays, 1,
                                                       CHECK_ROUNDS))
    prog["change_x"] = leaf_norms(state.x, x0)
    prog["change_xt"] = leaf_norms(state.x_tilde, x0)
    prog["loss"] = torch.cat([tr1.loss, tr2.loss]).cpu().numpy()
    # every run's window starts from the same collector state: the full
    # collections the window's garbage triggers then fall on the same calls
    gc.collect()
    return Program(sim, state, arrays, stream, prog, d_real, elem_bytes,
                   (first, time.perf_counter()))


def reference(cell: Cell, seed: int, arrays: dict, stream,
              device: torch.device, prec: str = "f32",
              fault: str | None = None) -> dict:
    """The reference's replay of the check's rounds, from the weights
    made again from the seed and the same stream's batches."""
    t = cell.traffic
    dyn = ref_replay.prop36(*schedule_gen.graph_edges(t["graph"],
                                                      t["workers"]),
                            t["workers"], t["accelerated"])
    return ref_replay.replay(
        cell.arch.init_params(cell.cfg, seed, device),
        schedule_gen.rounds_slice(arrays, 0, CHECK_ROUNDS), dyn,
        cell.wl["step_size"],
        lambda p, b: cell.reference.loss(p, cell.cfg, b), stream.batch,
        prec, fault)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(bench: spec.Bench, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t0: float) -> tuple:
    """Everything of a run but the look for a card.  Returns (the result
    dict without ``check``, the compared numbers, their limits)."""
    from repro_torch.core.engine import FlatGossipEngine

    cell = Cell(bench, name)
    cfg, t = cell.cfg, cell.traffic
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    spans = Spans(device)
    run = build(cell, seed, seconds, device, spans if traced else None)
    sim, state, arrays, per = run.sim, run.state, run.arrays, \
        cell.wl["rounds_per_call"]
    run.state = None
    sync()
    # ---------------------------------------------------------------- window
    orig_batch = FlatGossipEngine.batch
    if traced:
        FlatGossipEngine.batch = spans.wrap("comm", orig_batch)
    spans.marks.clear()
    try:
        start = time.perf_counter()
        setup_s = start - t0
        call_s, losses, r0 = [], [], CHECK_ROUNDS
        while r0 + per <= arrays["partners"].shape[0] - per:
            c0 = time.perf_counter()
            state, tr = sim.run_schedule(state, port_schedule(arrays, r0,
                                                              r0 + per))
            sync()
            call_s.append(time.perf_counter() - c0)
            losses.append(tr.loss)
            r0 += per
            if time.perf_counter() - start >= seconds:
                break
        else:
            print("perfbench: the schedule made in set-up ran out before "
                  "--seconds; the window is shorter", file=sys.stderr)
    finally:
        FlatGossipEngine.batch = orig_batch
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_spans = spans.seconds()
    rounds = len(call_s) * per
    window_loss = torch.cat(losses).cpu().numpy()
    profiled = None
    if traced and cuda:
        def one_call():
            sim.run_schedule(state, port_schedule(arrays, r0, r0 + per))
        profiled = trace.profile(one_call)
    # ------------------------------------------------------- output check
    del state, sim
    free(device)
    ref = reference(cell, seed, arrays, run.stream, device)
    numbers, where = check.compare(run.prog, ref)
    print(f"perfbench: worst leaves {where}", file=sys.stderr)
    limits = cell.wl["check"]
    correct = check.verdict(numbers, limits)
    # ---------------------------------------------------------------- result
    ctx = Context(unit=cell.arch.WORK_UNIT,
                  work=rounds * cell.arch.work_per_round(cfg, t),
                  rounds=rounds, call_s=call_s, setup_s=setup_s,
                  peak_bytes=peak, workers=t["workers"], d_real=run.d_real,
                  elem_bytes=run.elem_bytes,
                  flops_per_round=cell.arch.flops_per_round(cfg, t),
                  dtype=cfg["dtype"], spans=window_spans,
                  trace=profiled)
    metrics = {}
    wanted = bench.per_layer(name) if traced else bench.end_to_end(name)
    for m in wanted:
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rounds,
              "failed": int(np.sum(~np.isfinite(window_loss))),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "count": bench.cell(name)["chips"],
                         "memory_peak_bytes": int(peak)}}
    if traced and profiled:
        result["device"]["busy_s"] = profiled["busy_s"]
        result["device"]["window_s"] = profiled["window_s"]
        result["breakdown"] = {"device_ops": profiled["device_ops"],
                               "idle_gaps": profiled["idle_gaps"]}
    print(f"perfbench: {name} seed {seed}: setup {setup_s:.3f} s "
          f"(to the program's first call {run.marks[0] - t0:.3f}, its three "
          f"rounds {run.marks[1] - run.marks[0]:.3f}), {len(call_s)} calls "
          f"of {per} rounds in {sum(call_s):.3f} s "
          f"{[round(c, 4) for c in call_s]}, "
          f"losses {run.prog['loss'].tolist()} -> "
          f"{float(window_loss[-1]) if len(window_loss) else float('nan')}",
          file=sys.stderr)
    return result, numbers, limits


def forbidden_modules(names) -> list[str]:
    """Which of ``FORBIDDEN`` the module ``names`` hold, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def finish(result: dict, numbers: dict, limits: dict) -> str:
    """The result line, with the compared numbers last, and the same
    numbers as the last lines on standard error."""
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in check.NAMES}
    for k in check.NAMES:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    return json.dumps(result)


def main(argv, t0: float, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.Bench(root)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the configurations state float32: no TF32 products anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"perfbench: card {card_line()}", file=sys.stderr)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), t0)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    print(finish(*result))
    return 0
