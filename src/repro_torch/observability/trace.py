"""Span tracer: nested timing spans with Chrome-trace/Perfetto export
(the port's own copy of repro.observability.trace).

The engine's execution pipeline emits spans

    materialize → pass → partition → {stage, prefetch_wait,
                                      device_step, combine} → epilogue

on the thread that performs each piece of work, so the prefetcher's
background staging thread gets its OWN track and the stage/compute overlap
the paper's §III-F design promises is directly visible in the timeline.

Design constraints (this module is on the per-partition hot path):

  * **near-zero overhead when disabled** — ``span()`` returns a shared
    no-op context manager after a single attribute check; no allocation,
    no lock, no clock read;
  * **thread-safe when enabled** — events append under one lock; each
    event carries its thread id, and thread names are recorded as
    Chrome-trace metadata so Perfetto labels the tracks;
  * **timing fidelity** — span begin/end use ``time.perf_counter`` against
    a fixed epoch; the executor additionally blocks on device values
    inside ``device_step``/``combine`` spans *only while tracing*, so
    disabled runs keep their async dispatch behavior.

Use through the R-like surface:

    with fm.trace():                    # enable + collect
        fm.materialize(...)
    fm.trace_export("run.trace.json")   # chrome://tracing / ui.perfetto.dev

or ``fm.trace(export="run.trace.json")`` to export on scope exit.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared do-nothing context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.record(self._name, self._t0, time.perf_counter(),
                            self._args)
        return False


class SpanTracer:
    """Collect timing spans; export as Chrome-trace JSON.

    One process-wide instance (`TRACER`) is shared by the whole engine;
    ``enabled`` gates collection.  Events survive ``stop()`` so a trace can
    be exported after the traced block exits; ``reset()`` clears them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._thread_names: dict[int, str] = {}
        self._epoch = time.perf_counter()
        self.enabled = False

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one span.  Near-free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def record(self, name: str, t_start: float, t_end: float,
               args: Optional[dict] = None):
        """Record a completed span from raw ``perf_counter`` timestamps
        (for call sites that measure manually, e.g. the prefetch-queue
        wait, whose args are only known after the wait ends)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        ev = {
            "name": name,
            "ts": (t_start - self._epoch) * 1e6,   # µs, Chrome-trace unit
            "dur": max((t_end - t_start) * 1e6, 0.0),
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(ev)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self.enabled = True

    def stop(self):
        self.enabled = False

    def reset(self):
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
        self._epoch = time.perf_counter()

    @contextlib.contextmanager
    def recording(self, export: Optional[str] = None, *, reset: bool = True):
        """Enable tracing over a with-block (`fm.trace()`).  ``reset=True``
        starts from an empty buffer; ``export=`` writes the Chrome-trace
        JSON on exit."""
        if reset:
            self.reset()
        self.start()
        try:
            yield self
        finally:
            self.stop()
            if export is not None:
                self.export(export)

    # -- inspection / export -------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of collected span events (ts/dur in µs, per-thread)."""
        with self._lock:
            return [dict(ev) for ev in self._events]

    def chrome_trace(self) -> dict:
        """The trace as a Chrome-trace JSON object: complete ('X') events
        plus thread-name metadata, loadable by chrome://tracing and
        ui.perfetto.dev."""
        with self._lock:
            events = [dict(ev) for ev in self._events]
            names = dict(self._thread_names)
        trace_events = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch.fm engine"}},
        ]
        for tid, tname in sorted(names.items()):
            trace_events.append(
                {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                 "args": {"name": tname}})
        for ev in events:
            out = {"ph": "X", "cat": "fm", "pid": 0,
                   "name": ev["name"], "tid": ev["tid"],
                   "ts": round(ev["ts"], 3), "dur": round(ev["dur"], 3)}
            if "args" in ev:
                out["args"] = ev["args"]
            trace_events.append(out)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export(self, path) -> str:
        """Write the Chrome-trace JSON to ``path``; returns the path."""
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)
            fh.write("\n")
        return str(path)


#: The process-wide tracer every engine layer records into.
TRACER = SpanTracer()


def span(name: str, **args):
    """Module-level shorthand: ``trace.span('pass', idx=0)``."""
    return TRACER.span(name, **args)
