"""Host-side instrumentation: the span tracer (Chrome trace JSON) and the
metrics registry (Prometheus text), copies of the JAX package's stdlib-only
modules.  ``hlo_cost`` and ``roofline`` parse XLA HLO and are not ported."""
from .metrics import MetricsRegistry, parse_exposition
from .tracing import SpanTracer, load_trace, validate_trace

__all__ = ["MetricsRegistry", "parse_exposition", "SpanTracer",
           "load_trace", "validate_trace"]
