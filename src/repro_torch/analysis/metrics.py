"""Host-side metrics registry with Prometheus-style text exposition
(DESIGN.md §15), a copy of ``repro.analysis.metrics`` (stdlib only)
without its JSON ``snapshot``, so that the port imports nothing of the JAX
package.

The span tracer (``analysis/tracing.py``) answers "when did the host do
what"; this registry answers "how much, in total" — monotonic counters,
point-in-time gauges, and bucketed histograms, labeled Prometheus-style:

    reg = MetricsRegistry()
    reg.counter("fleet_requests_total", "requests admitted",
                labels={"fleet": "ring"}).inc()
    reg.histogram("fleet_ttft_rounds", "time to first token",
                  buckets=(1, 2, 4, 8)).observe(3.0)
    text = reg.exposition()     # Prometheus text format 0.0.4

Stdlib-only, no server: ``exposition()`` is plain text, so any Prometheus
scraper (or a human with grep) can read fleet health without the repo.
"""
from __future__ import annotations

import math
from typing import Iterable


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r} (want "
                         "[a-zA-Z0-9_:]+)")
    if name[0].isdigit():
        raise ValueError(f"metric name {name!r} must not start with a "
                         "digit")
    return name


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter (one labeled child of a family)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        self.value += amount


class Gauge:
    """Point-in-time value."""

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper edge; +Inf is implicit)."""

    def __init__(self, buckets: Iterable[float]):
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)) or not edges:
            raise ValueError("histogram buckets must be strictly "
                             f"increasing and non-empty, got {edges}")
        self.edges = edges
        self.bucket_counts = [0] * (len(edges) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, edge in enumerate(self.edges):
            if v <= edge:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> list[int]:
        out, run = [], 0
        for c in self.bucket_counts:
            run += c
            out.append(run)
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Families of labeled counters/gauges/histograms."""

    def __init__(self):
        # name -> (type, help, {label_str: child})
        self._families: dict[str, tuple[str, str, dict]] = {}

    def _family(self, kind: str, name: str, help_: str):
        _validate_name(name)
        fam = self._families.get(name)
        if fam is None:
            fam = (kind, help_, {})
            self._families[name] = fam
        elif fam[0] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam[0]}, not {kind}")
        return fam

    def counter(self, name: str, help_: str = "",
                labels: dict | None = None) -> Counter:
        fam = self._family("counter", name, help_)
        key = _label_str({k: str(v) for k, v in (labels or {}).items()})
        return fam[2].setdefault(key, Counter())

    def gauge(self, name: str, help_: str = "",
              labels: dict | None = None) -> Gauge:
        fam = self._family("gauge", name, help_)
        key = _label_str({k: str(v) for k, v in (labels or {}).items()})
        return fam[2].setdefault(key, Gauge())

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = (0.005, 0.05, 0.5, 5.0),
                  labels: dict | None = None) -> Histogram:
        fam = self._family("histogram", name, help_)
        key = _label_str({k: str(v) for k, v in (labels or {}).items()})
        return fam[2].setdefault(key, Histogram(buckets))

    # ---------------------------------------------------------- exposition
    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for name, (kind, help_, children) in sorted(
                self._families.items()):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, child in sorted(children.items()):
                if kind in ("counter", "gauge"):
                    lines.append(f"{name}{key} "
                                 f"{_fmt_value(child.value)}")
                    continue
                # histogram: cumulative le-buckets + _sum + _count
                cum = child.cumulative()
                base = key[1:-1] if key else ""
                for edge, c in zip(child.edges + (math.inf,), cum):
                    le = f'le="{_fmt_value(edge)}"'
                    lab = "{" + (base + "," if base else "") + le + "}"
                    lines.append(f"{name}_bucket{lab} {c}")
                lines.append(f"{name}_sum{key} {_fmt_value(child.sum)}")
                lines.append(f"{name}_count{key} {child.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_exposition(text: str) -> dict:
    """Minimal parser for the text format (the round-trip test gate):
    returns ``{name: {label_str: value}}`` for sample lines, skipping
    comments.  Raises ``ValueError`` on malformed lines."""
    out: dict[str, dict[str, float]] = {}
    for ln, line in enumerate(text.splitlines()):
        if not line.strip() or line.startswith("#"):
            continue
        try:
            metric, value = line.rsplit(" ", 1)
        except ValueError:
            raise ValueError(f"line {ln}: no value in {line!r}") from None
        if "{" in metric:
            name, rest = metric.split("{", 1)
            if not rest.endswith("}"):
                raise ValueError(f"line {ln}: unterminated labels in "
                                 f"{line!r}")
            labels = "{" + rest
        else:
            name, labels = metric, ""
        _validate_name(name)
        v = float(value) if value not in ("+Inf", "-Inf") \
            else math.inf * (1 if value == "+Inf" else -1)
        out.setdefault(name, {})[labels] = v
    return out
