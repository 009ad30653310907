"""Host-side span tracer: Chrome-trace-event JSON (DESIGN.md §15), a
copy of ``repro.analysis.tracing`` (stdlib only), so that the port imports
nothing of the JAX package.

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
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any

# trace-event phases we emit (and validate_trace accepts)
_PHASES = {"X", "C", "i", "M"}


class SpanTracer:
    """Collects Chrome trace events; write once at the end of a run.

    process/thread ids are logical labels (pid = subsystem, tid = lane),
    not OS ids — Perfetto renders each (pid, tid) pair as its own track.
    """

    def __init__(self, process: str = "repro", *,
                 metadata: dict | None = None):
        self._origin = time.perf_counter()
        self.events: list[dict] = []
        self.metadata: dict = dict(metadata or {})
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[int, str], int] = {}
        self._root = process
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
    @contextmanager
    def span(self, name: str, *, process: str | None = None,
             lane: str = "main", args: dict | None = None):
        """Context manager emitting one complete ("X") span.  ``process``
        defaults to the tracer's root process (every emitter below
        does)."""
        pid = self.process(process or self._root)
        tid = self.thread(pid, lane)
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.events.append({
                "ph": "X", "name": name, "pid": pid, "tid": tid,
                "ts": t0, "dur": self.now_us() - t0,
                "args": _jsonable(args or {})})

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
        (one multi-series counter track per ``name``)."""
        pid = self.process(process or self._root)
        self.events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                            "ts": self.now_us(),
                            "args": {k: float(v) for k, v in
                                     values.items()}})

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
