"""The arithmetic behind the per-layer metrics, shared by their readers in
``metrics/``.  Each takes the run's context (``harness.Context``) and
returns a number, or None where the run has nothing to read.

  * the gradient tick's span (CUDA events around the ``grad_fn`` handed to
    the port's ``Simulator``), per tick;
  * the comm step's roofline share: its least bytes, x and x~ of every
    worker read and written once (4 W d_real element sizes), at the HBM's
    peak, over the measured comm-step time;
  * the rest of a round: call wall time less gradient and comm spans;
  * the step's share of the peak: the model's FLOPs of the window's
    rounds over its wall time, against the peak of the configuration's
    dtype (``peaks.py``);
  * the device's idle share in the traced call.
"""
from __future__ import annotations

from . import peaks

PEAK_FLOPS = {"float32": peaks.F32_FLOPS, "bfloat16": peaks.BF16_FLOPS}


def grad_ms(ctx) -> float | None:
    spans = ctx.spans.get("grad", [])
    return 1e3 * sum(spans) / len(spans) if spans else None


def comm_roofline_pct(ctx) -> float | None:
    spans = ctx.spans.get("comm", [])
    if not spans:
        return None
    least_bytes = 4 * ctx.workers * ctx.d_real * ctx.elem_bytes
    return 100.0 * len(spans) * least_bytes / peaks.HBM_BYTES_PER_S \
        / sum(spans)


def rest_ms(ctx) -> float | None:
    if "grad" not in ctx.spans:
        return None
    rest = sum(ctx.call_s) - sum(ctx.spans["grad"]) \
        - sum(ctx.spans.get("comm", []))
    return 1e3 * rest / ctx.rounds


def mfu_pct(ctx) -> float | None:
    return 100.0 * ctx.flops_per_round * ctx.rounds / sum(ctx.call_s) \
        / PEAK_FLOPS[ctx.dtype]


def device_idle_pct(ctx) -> float | None:
    if not ctx.trace:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
