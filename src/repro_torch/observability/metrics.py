"""Scoped, thread-safe metrics registry (the port's own copy of
repro.observability.metrics) (counters, last-value slots,
histograms) — the engine's structured replacement for ad-hoc module-global
counter dicts.

Two kinds of scope:

  * the **root scope** — process-global, always recording.  The
    compatibility view ``repro_torch.core.materialize.exec_stats()`` reads it,
    so every pre-existing counter assertion keeps working.
  * **collection scopes** — opened with ``fm.collect_stats()`` (a context
    manager yielding the scope).  A scope records only what the *current
    thread* (plus pipeline threads it explicitly spawns, see
    ``current_scopes``/``use_scopes``) does while it is open: two
    concurrent materialize calls in two threads, each inside its own
    ``collect_stats()``, observe only their own execution — the
    per-request isolation an admission-controlling serving layer needs
    (ROADMAP item 2).

Metric kinds:

  * ``inc(name, v)``     — monotonic counter (calls, bytes, seconds);
  * ``put(name, value)`` — last-value slot (the per-pass byte tuple of the
    most recent execution, published atomically at execution end — never
    half-updated by an interleaved materialize);
  * ``observe(name, v)`` — histogram summary (count/total/min/max), e.g.
    prefetch-queue occupancy samples.

``Scope.stats()`` returns a plain dict: counters and values verbatim,
histograms as ``{name: {count, total, min, max, mean}}``, plus derived
rates — ``stream_bandwidth_bytes_s`` (slow-tier staging read bandwidth),
``prefetch_wait_frac`` (fraction of streaming wall time the compute thread
spent blocked on the staging queue) and ``plan_cache_hit_ratio``.

The registry takes one small lock per recording call and nothing else:
cheap enough to stay always-on (the CI bench gate holds it to no
measurable wall-time regression).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Optional

#: Counter pairs that define the derived rates in ``derive()``.
_DERIVED_DOC = {
    "stream_bandwidth_bytes_s": ("stage_bytes_read", "stage_read_seconds"),
    "prefetch_wait_frac": ("prefetch_wait_seconds", "pass_seconds"),
    "plan_cache_hit_ratio": ("plan_cache_hits",
                             "plan_cache_hits + plan_cache_misses"),
}


class _Hist:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float):
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def snapshot(self) -> dict:
        return {"count": self.count, "total": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": (self.total / self.count) if self.count else 0.0}


class Scope:
    """One collector: counters + last-value slots + histograms."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._values: dict[str, object] = {}
        self._hists: dict[str, _Hist] = {}

    # -- recording ----------------------------------------------------------
    def inc(self, name: str, v: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + v

    def put(self, name: str, value):
        with self._lock:
            self._values[name] = value

    def observe(self, name: str, v: float):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.observe(v)

    # -- reading ------------------------------------------------------------
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def value(self, name: str, default=None):
        with self._lock:
            return self._values.get(name, default)

    def stats(self) -> dict:
        """Snapshot: counters/values verbatim, histogram summaries, and the
        derived bandwidth / wait-fraction / cache-hit-ratio rates."""
        with self._lock:
            out: dict = dict(self._counters)
            out.update(self._values)
            for name, h in self._hists.items():
                out[name] = h.snapshot()
        return derive(out)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._values.clear()
            self._hists.clear()

    def __repr__(self):
        return f"Scope({self.name or 'anon'}, {len(self._counters)} counters)"


def derive(stats: dict) -> dict:
    """Attach the derived rate metrics to a raw stats dict (in place)."""
    read_s = stats.get("stage_read_seconds", 0.0)
    stats["stream_bandwidth_bytes_s"] = (
        stats.get("stage_bytes_read", 0.0) / read_s if read_s > 0 else 0.0)
    loop_s = stats.get("pass_seconds", 0.0)
    stats["prefetch_wait_frac"] = (
        min(stats.get("prefetch_wait_seconds", 0.0) / loop_s, 1.0)
        if loop_s > 0 else 0.0)
    lookups = (stats.get("plan_cache_hits", 0.0)
               + stats.get("plan_cache_misses", 0.0))
    stats["plan_cache_hit_ratio"] = (
        stats.get("plan_cache_hits", 0.0) / lookups if lookups > 0 else 0.0)
    return stats


class MetricsRegistry:
    """The root scope plus a per-thread stack of collection scopes.  Every
    recording call fans out to the root and to the calling thread's open
    scopes, so scoped collection never loses the global view."""

    def __init__(self):
        self.root = Scope("root")
        self._local = threading.local()

    # -- scope plumbing ------------------------------------------------------
    def _stack(self) -> list[Scope]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def scopes(self) -> tuple[Scope, ...]:
        """Every scope the current thread records into (root first)."""
        return (self.root, *self._stack())

    def current_scopes(self) -> tuple[Scope, ...]:
        """The current thread's OPEN collection scopes (no root) — capture
        these before spawning a pipeline thread and re-enter them there
        with ``use_scopes`` so background staging work is attributed to
        the request that spawned it."""
        return tuple(self._stack())

    @contextlib.contextmanager
    def use_scopes(self, scopes: Iterable[Scope]):
        """Adopt another thread's collection scopes for a with-block (the
        prefetcher's worker thread runs its whole loop under this)."""
        st = self._stack()
        saved = list(st)
        st[:] = list(scopes)
        try:
            yield
        finally:
            st[:] = saved

    @contextlib.contextmanager
    def collect(self, name: str = ""):
        """``fm.collect_stats()``: open a fresh scope on this thread; yields
        the `Scope` (read it with ``.stats()`` during or after the block)."""
        scope = Scope(name)
        st = self._stack()
        st.append(scope)
        try:
            yield scope
        finally:
            st.remove(scope)

    # -- recording (fans out to root + open scopes) --------------------------
    def inc(self, name: str, v: float = 1.0):
        for s in self.scopes():
            s.inc(name, v)

    def put(self, name: str, value):
        for s in self.scopes():
            s.put(name, value)

    def observe(self, name: str, v: float):
        for s in self.scopes():
            s.observe(name, v)

    # -- reading / reset -----------------------------------------------------
    def stats(self) -> dict:
        return self.root.stats()

    def reset(self):
        """Reset the ROOT scope (collection scopes are ephemeral — their
        owners hold them)."""
        self.root.reset()


#: The process-wide registry the engine records into.
REGISTRY = MetricsRegistry()

# Module-level shorthands (hot-path call sites use these).
inc = REGISTRY.inc
put = REGISTRY.put
observe = REGISTRY.observe
collect = REGISTRY.collect
current_scopes = REGISTRY.current_scopes
use_scopes = REGISTRY.use_scopes
stats = REGISTRY.stats
reset = REGISTRY.reset


def root_counter(name: str) -> float:
    return REGISTRY.root.counter(name)


def root_value(name: str, default=None):
    return REGISTRY.root.value(name, default)
