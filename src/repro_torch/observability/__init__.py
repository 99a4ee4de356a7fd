"""Observability: span tracing, scoped metrics and plan explain (the port's
own copies of repro.observability).

* `trace`   — nested timing spans with Chrome-trace/Perfetto export
  (``fm.trace(...)`` / ``fm.trace_export(path)``);
* `metrics` — thread-safe scoped counters/gauges/histograms behind the
  ``exec_stats()`` compatibility view, plus ``fm.collect_stats()`` for
  per-request isolation;
* `explain` — the fused-plan pretty-printer behind ``fm.explain(x)``.

`trace` and `metrics` are stdlib-only (core imports this package at module
load); `explain` imports core lazily inside its functions.
"""
from . import explain, metrics, trace                       # noqa: F401
from .explain import explain as explain_outputs, explain_plan  # noqa: F401
from .metrics import REGISTRY, Scope                        # noqa: F401
from .trace import TRACER, SpanTracer, span                 # noqa: F401
