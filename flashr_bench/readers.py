"""Arithmetic the metric readers share (``metrics/<metric>.py``).  Each
reader returns None where its run has nothing to read."""
from __future__ import annotations

from flashr_bench import peaks


def rate_gb_s(run) -> float | None:
    """Counted bytes of the completed calls over the window, GB/s."""
    if run.window_s <= 0 or run.counted["bytes"] <= 0:
        return None
    return run.counted["bytes"] / run.window_s / 1e9


def idle_pct(run) -> float | None:
    """100 · (1 - the device's busy union / the traced window)."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernels_roofline_pct(run) -> float | None:
    """100 · the counted work's roofline time / the summed time of every
    kernel the trace holds."""
    t = run.trace
    if not t or t["kernel_s"] <= 0:
        return None
    return 100.0 * peaks.bound(run.counted["bytes"],
                               run.counted["flops"]) / t["kernel_s"]
