"""Observability: span tracing and scoped metrics (the port's own copies;
``explain`` comes with the observability slice, ROADMAP A10)."""
from . import metrics, trace                                # noqa: F401
from .metrics import REGISTRY, Scope                        # noqa: F401
from .trace import TRACER, SpanTracer, span                 # noqa: F401
