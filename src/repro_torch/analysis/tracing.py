"""Span tracer: Chrome-trace-event JSON (DESIGN.md §15).  It began as a
copy of ``repro.analysis.tracing`` and adds what the port's replay needs:
an active tracer that the program's own code records to, parent links,
device time on CUDA events, profiler ranges and garbage-collector pauses.

The compiled side of the flight recorder (``core/telemetry.py``) records
WHAT the replay did, per round, as data on the scan carry.  This module
records WHEN the host did things around those replays: jit traces,
dispatches, fleet rounds, prefill/decode steps, drain — as *spans* in the
Chrome trace event format, loadable directly into Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Event vocabulary (the subset of the trace-event spec we emit):

  * ``ph: "X"`` — complete spans (name, ts, dur in microseconds);
  * ``ph: "C"`` — counter samples (queue depth, slot occupancy,
    consensus), rendered as stacked track charts;
  * ``ph: "i"`` — instant events (churn kills, quarantine convictions);
  * ``ph: "M"`` — metadata (process/thread names).

One ``SpanTracer`` is one trace file: ``{"traceEvents": [...]}`` plus a
top-level ``metadata`` dict for run parameters.  All timestamps come from
one ``time.perf_counter`` origin captured at construction, so spans from
different subsystems (fleet loop, benchmark harness) line up on one
timeline.  ``validate_trace`` is the schema gate used by the tests and
the CI trace-smoke step.

Spans nest: each ``span`` carries its own ``id`` and its parent's
(``parent``, 0 at the top) in its args, from a stack per thread; a
``counter`` sample names the innermost open span as its ``parent`` and
adds its values to that span's args.  A tracer made with a CUDA
``device`` also records a CUDA event pair on the current stream around
each span; ``resolve`` reads the pairs once the work is done and adds
``device_ms`` to the span's args.  Nothing synchronises while spans are
recorded, and the events stay in memory until ``to_dict``/``write``.

The program records to the *active* tracer through the module-level
``span(name, **args)`` and ``count(name, **values)``:

    tracer = SpanTracer("run", device=torch.device("cuda"))
    with tracer.activate():
        sim.run_schedule(state, sched)      # replay.* spans and counters
    tracer.resolve()

With no tracer active, ``span`` returns one shared null context and
``count`` returns at once: no event, no profiler range, no list append.
While a tracer is active, each of its spans also opens a
``torch.profiler.record_function`` range of the same name, so under
``torch.profiler`` the program's spans sit on the device trace's clock
next to the kernels they launched, and a ``gc.callbacks`` hook records
each collection as a ``python.gc`` span (its generation and the objects
it collected).
"""
from __future__ import annotations

import gc
import json
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any

import torch

# trace-event phases we emit (and validate_trace accepts)
_PHASES = {"X", "C", "i", "M"}

# the tracer that ``span`` and ``count`` record to (``SpanTracer.activate``)
_active: SpanTracer | None = None
_NULL = nullcontext()


def active() -> SpanTracer | None:
    """The active tracer, or None."""
    return _active


def span(name: str, **args):
    """A span of the active tracer (``with span("replay.tick"): ...``);
    the shared null context when none is active."""
    tracer = _active
    return _NULL if tracer is None else tracer.span(name, args=args)


def count(name: str, **values) -> None:
    """A counter sample of the active tracer; nothing when none is
    active."""
    tracer = _active
    if tracer is not None:
        tracer.counter(name, values)


def count_device(name: str, **values) -> None:
    """A counter sample whose values may be tensors on the card: read
    when the tracer resolves, never before; nothing when none is
    active."""
    tracer = _active
    if tracer is not None:
        tracer.device_counter(name, values)


class _Span:
    """One open span of ``tracer`` (``SpanTracer.span``)."""

    __slots__ = ("tracer", "name", "pid", "tid", "args", "id", "t0",
                 "start", "rf")

    def __init__(self, tracer: SpanTracer, name: str, pid: int, tid: int,
                 args: dict):
        self.tracer, self.name, self.pid, self.tid = tracer, name, pid, tid
        self.args = args

    def __enter__(self) -> SpanTracer:
        tr = self.tracer
        stack = tr._stack()
        tr._last_id += 1
        self.id = tr._last_id
        self.args["id"] = self.id
        self.args["parent"] = stack[-1].id if stack else 0
        stack.append(self)
        self.rf = None
        if tr is _active:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = None
        if tr.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = tr.now_us()
        return tr

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        t1 = tr.now_us()
        ev = {"ph": "X", "name": self.name, "pid": self.pid,
              "tid": self.tid, "ts": self.t0, "dur": t1 - self.t0,
              "args": _jsonable(self.args)}
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            tr._pending.append((ev, self.start, end))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tr._stack().pop()
        tr.events.append(ev)
        return False


class SpanTracer:
    """Collects Chrome trace events; write once at the end of a run.

    process/thread ids are logical labels (pid = subsystem, tid = lane),
    not OS ids — Perfetto renders each (pid, tid) pair as its own track.
    """

    def __init__(self, process: str = "repro", *,
                 metadata: dict | None = None, device=None):
        self._origin = time.perf_counter()
        self.events: list[dict] = []
        self.metadata: dict = dict(metadata or {})
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[int, str], int] = {}
        self._root = process
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._local = threading.local()
        self._last_id = 0
        self._pending: list[tuple[dict, Any, Any]] = []
        self._pending_counts: list[tuple[dict, dict]] = []
        self._gc_open: tuple | None = None
        self.process(process)

    # ------------------------------------------------------------- identity
    def process(self, name: str) -> int:
        """Logical process id for ``name`` (created + announced once)."""
        if name not in self._pids:
            pid = len(self._pids) + 1
            self._pids[name] = pid
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0,
                                "args": {"name": name}})
        return self._pids[name]

    def thread(self, pid: int, name: str) -> int:
        """Logical thread id for a lane within process ``pid``."""
        key = (pid, name)
        if key not in self._tids:
            tid = sum(1 for p, _ in self._tids if p == pid) + 1
            self._tids[key] = tid
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": name}})
        return self._tids[key]

    # ---------------------------------------------------------------- clock
    def now_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    # --------------------------------------------------------------- events
    def span(self, name: str, *, process: str | None = None,
             lane: str = "main", args: dict | None = None) -> _Span:
        """Context manager emitting one complete ("X") span.  ``process``
        defaults to the tracer's root process (every emitter below
        does)."""
        pid = self.process(process or self._root)
        return _Span(self, name, pid, self.thread(pid, lane),
                     dict(args or {}))

    def _stack(self) -> list[_Span]:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 process: str | None = None, lane: str = "main",
                 args: dict | None = None) -> None:
        """An explicit-timestamp "X" span (for durations measured
        elsewhere, e.g. ``_timeit`` results)."""
        pid = self.process(process or self._root)
        tid = self.thread(pid, lane)
        self.events.append({"ph": "X", "name": name, "pid": pid,
                            "tid": tid, "ts": float(ts_us),
                            "dur": float(dur_us),
                            "args": _jsonable(args or {})})

    def instant(self, name: str, *, process: str | None = None,
                lane: str = "main", args: dict | None = None) -> None:
        """A point-in-time ("i") event, thread-scoped."""
        pid = self.process(process or self._root)
        tid = self.thread(pid, lane)
        self.events.append({"ph": "i", "name": name, "pid": pid,
                            "tid": tid, "ts": self.now_us(), "s": "t",
                            "args": _jsonable(args or {})})

    def counter(self, name: str, values: dict, *,
                process: str | None = None) -> None:
        """A counter ("C") sample: ``values`` maps series name -> number
        (one multi-series counter track per ``name``).  Inside an open
        span the sample names it as ``parent`` and adds its values to the
        span's args."""
        pid = self.process(process or self._root)
        stack = self._stack()
        if stack:
            stack[-1].args.update(values)
        self.events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                            "ts": self.now_us(),
                            "parent": stack[-1].id if stack else 0,
                            "args": {k: float(v) for k, v in
                                     values.items()}})

    def device_counter(self, name: str, values: dict, *,
                       process: str | None = None) -> None:
        """A counter ("C") sample whose values may be tensors (on the
        card): the event names the innermost open span as ``parent`` at
        once, and takes its values in ``resolve``, so that recording
        never waits for the card."""
        pid = self.process(process or self._root)
        stack = self._stack()
        ev = {"ph": "C", "name": name, "pid": pid, "tid": 0,
              "ts": self.now_us(), "parent": stack[-1].id if stack else 0,
              "args": {}}
        self.events.append(ev)
        self._pending_counts.append((ev, dict(values)))

    # ---------------------------------------------------- active recording
    @contextmanager
    def activate(self):
        """Install this tracer as the one that ``span`` and ``count``
        record to, and hook the garbage collector, until the block ends."""
        global _active
        prev, _active = _active, self
        gc.callbacks.append(self._on_gc)
        try:
            yield self
        finally:
            gc.callbacks.remove(self._on_gc)
            _active = prev

    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: each collection as a ``python.gc`` span
        under the innermost open span, with a profiler range."""
        if phase == "start":
            rf = torch.profiler.record_function("python.gc")
            rf.__enter__()
            self._gc_open = (self.now_us(), rf)
            return
        if self._gc_open is None:
            return
        t0, rf = self._gc_open
        self._gc_open = None
        rf.__exit__(None, None, None)
        stack = self._stack()
        self._last_id += 1
        pid = self.process(self._root)
        self.events.append({
            "ph": "X", "name": "python.gc", "pid": pid,
            "tid": self.thread(pid, "main"), "ts": t0,
            "dur": self.now_us() - t0,
            "args": {"generation": info["generation"],
                     "collected": info["collected"], "id": self._last_id,
                     "parent": stack[-1].id if stack else 0}})

    def resolve(self) -> SpanTracer:
        """Wait for the device, then add each recorded span's CUDA event
        time to its args as ``device_ms``, and give each device counter
        its values."""
        if self._pending:
            torch.cuda.synchronize()
            for ev, start, end in self._pending:
                ev["args"]["device_ms"] = start.elapsed_time(end)
            self._pending.clear()
        for ev, values in self._pending_counts:
            ev["args"] = {k: float(v) for k, v in values.items()}
        self._pending_counts.clear()
        return self

    # ----------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "metadata": _jsonable(self.metadata)}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path


def _jsonable(obj: Any) -> Any:
    """Coerce numpy scalars, tensors and arrays into plain JSON types."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item") and getattr(obj, "ndim", None) in (0, None):
        try:
            return obj.item()
        except Exception:
            return str(obj)
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


# ------------------------------------------------------------------ schema

def validate_trace(obj: dict) -> None:
    """Raise ``ValueError`` unless ``obj`` is a loadable Chrome trace.

    The golden-schema gate for every ``TRACE_*.json`` artifact: object
    format with a ``traceEvents`` list; every event carries a known
    phase, a name, integer pid/tid; timed phases carry numeric ``ts``
    (and ``dur`` for "X"); args (when present) are JSON objects.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got "
                         f"{type(obj).__name__}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace must carry a 'traceEvents' list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"traceEvents[{i}]: unknown phase {ph!r} "
                             f"(expected one of {sorted(_PHASES)})")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"traceEvents[{i}]: missing/empty name")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                raise ValueError(f"traceEvents[{i}]: {field} must be an "
                                 f"int, got {ev.get(field)!r}")
        if ph in ("X", "C", "i"):
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"traceEvents[{i}]: ts must be a number")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}]: 'X' span needs a "
                             "numeric dur")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float))
                    for v in args.values()):
                raise ValueError(f"traceEvents[{i}]: 'C' sample needs a "
                                 "non-empty numeric args dict")
        elif "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"traceEvents[{i}]: args must be an object")


def load_trace(path: str) -> dict:
    """Read + validate one ``TRACE_*.json`` artifact."""
    with open(path) as f:
        obj = json.load(f)
    validate_trace(obj)
    return obj
