"""The device trace of a measured window and its reduction.

``torch.profiler`` traces the window (CPU and CUDA activity).  One user
annotation opened at a known host time aligns the trace's clock with
``time.perf_counter``, so the benchmark's own spans (which call was open)
name each idle gap of the device.  The program's span tracer stays off:
switching it on makes the executor synchronize at every step and changes
the timeline being measured.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

ANCHOR = "flashr_bench.anchor"
#: Trace categories of work on the device: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """Context manager: profile the block; ``events()`` then gives the
    device's operations as ``(name, category, start, end)`` in
    ``time.perf_counter`` seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_anchor = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(ANCHOR):
            self.t_anchor = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        evs = trace["traceEvents"] if isinstance(trace, dict) else trace
        anchor = [e for e in evs if e.get("name") == ANCHOR and "ts" in e]
        if not anchor:
            return []
        offset_us = float(anchor[0]["ts"]) - self.t_anchor * 1e6
        out = []
        for e in evs:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                s = (float(e["ts"]) - offset_us) / 1e6
                out.append((e.get("name", "?"), e["cat"], s,
                            s + float(e.get("dur", 0.0)) / 1e6))
        return out


def reduce(events: list, t0: float, t1: float, span_at) -> dict | None:
    """Busy union, kernel time and count, operations by time and idle gaps
    by the host span open at each gap's middle, over ``[t0, t1]``.  None
    when the trace holds no device operation in the window."""
    clipped = [(n, c, max(s, t0), min(e, t1)) for n, c, s, e in events
               if e > t0 and s < t1]
    if not clipped:
        return None
    kernels = [(s, e) for n, c, s, e in clipped if c == "kernel"]
    by_name: dict = {}
    for n, c, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    merged = []
    for s, e in sorted((s, e) for _, _, s, e in clipped):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    idle: dict = {}
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = span_at((a + b) / 2)
            idle[name] = idle.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": t1 - t0, "busy_s": busy,
            "kernel_s": sum(e - s for s, e in kernels),
            "kernels": len(kernels),
            "device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in gaps]}
