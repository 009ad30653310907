"""Instrumentation: the span tracer (Chrome trace JSON) and the metrics
registry (Prometheus text), copies of the JAX package's stdlib-only
modules; the op-level cost counter (``op_cost``, the counterpart of the JAX
package's HLO-text ``hlo_cost``) and the roofline terms with the H100's
peaks (``roofline``)."""
from .metrics import MetricsRegistry, parse_exposition
from .op_cost import OpCost, OpCounter, count, record
from .roofline import RooflineReport, model_flops, roofline_terms
from .tracing import SpanTracer, load_trace, validate_trace

__all__ = ["MetricsRegistry", "parse_exposition", "OpCost", "OpCounter",
           "count", "record", "RooflineReport", "model_flops",
           "roofline_terms", "SpanTracer", "load_trace", "validate_trace"]
