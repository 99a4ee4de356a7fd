"""Fault-tolerance runtime: preemption, stragglers — the port of
repro/runtime/fault_tolerance.py (pure Python).

**Preemption / crash** — ``PreemptionGuard`` installs SIGTERM/SIGINT
handlers that request a final synchronous checkpoint at the next step
boundary; with checkpoint/checkpoint.py's atomic saves the job loses at
most one step plus the async-save lag.

**Stragglers** — ``StragglerMonitor`` tracks per-step wall times; a step
slower than ``threshold × median`` is logged and flagged.

**Elastic re-mesh** — ``rescale_grad_accum`` holds the global batch across
a change of data-parallel width.  ``replan_mesh`` needs the LM half of the
sharding policy and raises until it is ported (ROADMAP A14).
"""
from __future__ import annotations

import logging
import signal
import statistics
import time
from typing import Optional

log = logging.getLogger("repro_torch.runtime")


class PreemptionGuard:
    """SIGTERM/SIGINT → request checkpoint-and-exit at next step boundary."""

    def __init__(self):
        self.requested = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:           # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s: checkpoint at next boundary", signum)
        self.requested = True

    def restore_handlers(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


def replan_mesh(n_devices: int, *, prefer_model: int = 16):
    """The largest (data, model) grid for the surviving device count: needs
    the LM half of the sharding policy (ROADMAP A14)."""
    raise NotImplementedError(
        "replan_mesh: the (data, model) LM mesh and its parameter shardings "
        "come with the sharded train step (ROADMAP A14)")


def rescale_grad_accum(cfg_accum: int, old_data: int, new_data: int) -> int:
    """Hold the global batch constant across a re-mesh: fewer data shards
    => proportionally more microbatches."""
    return max(1, int(round(cfg_accum * old_data / max(1, new_data))))


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: list = []
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                self.flagged.append((step, seconds, med))
                log.warning("straggler: step %d took %.2fs (median %.2fs)",
                            step, seconds, med)
                return True
        return False


class StepTimer:
    def __init__(self, monitor: Optional[StragglerMonitor] = None):
        self.monitor = monitor or StragglerMonitor()
        self._t0 = None
        self.step = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.monitor.record(self.step, dt)
        self.step += 1
        return False
