"""The device trace of one steady call, and its reduction.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` inside a
``perfbench.window`` annotation that ends after a synchronise, writes the
Chrome trace under ``TMPDIR`` and reads it back.  ``summarize`` reduces the
events: the union of the device's operations (kernels, copies, sets)
inside the window is ``busy_s``; the window's length ``window_s``; the ten
operations that took most device time; and the ten host activities under
which the device sat idle longest (each gap named by the innermost host
event that covers its middle).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def profile(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)


def _union(spans):
    """Merged, sorted intervals of ``spans`` [(start, end), ...]."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list[dict], top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (lists of
    [name, seconds]) of a Chrome trace's events; times there are in us."""
    full = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in full if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    for e in full:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
                by_name[e["name"]] += (b - a) * 1e-6
    if not dev:
        return {}
    busy = _union(dev)
    # the window's thread's events nest: a sweep keeps the stack of those
    # open at each gap's middle, innermost on top
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in full
                   if e.get("cat") in HOST_CATS
                   and e.get("tid") == win[0].get("tid")
                   and e.get("name") != WINDOW))
    gaps, stack, i = defaultdict(float), [], 0
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "host (no event)"] += (b - a) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}
