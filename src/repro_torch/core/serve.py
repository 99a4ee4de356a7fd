"""Async multi-tenant serving layer (PyTorch port of repro.core.serve).

FlashR's deployment shape is one engine serving many users' R programs
over shared SSD-resident matrices.  ``fm.batch`` co-schedules k plans onto
one stream when one caller assembles the batch; `Engine` does it for
CONCURRENT callers:

  1. ``submit(*outputs)`` (any thread) plans the request at once — its own
     `fusion.Plan`, plan-cache template and metrics scopes — and returns a
     `RequestHandle` future;
  2. requests wait in a short **admission window**; when it closes they
     are co-scheduled by `fusion.stream_group_key` exactly as a batch is:
     strangers whose plans stream the same physical matrix share ONE
     partition sweep (``exec_stats()['streams'] == 1`` a window);
  3. each group runs on a worker pool bounded by ``max_concurrent_streams``
     and by an **in-flight streamed-bytes cap** derived from the measured
     staging rate (``stage_bytes_read`` / ``stage_read_seconds``): k streams
     do not thrash one disk;
  4. a late request whose plan matches a LIVE group (same long dimension,
     a subset of its sources, row-addressed outputs) is **admitted
     mid-stream** at the next partition boundary: it rides the remaining
     partitions with the group, then the runner re-drives only the prefix
     it missed (`materialize._catch_up`).

Streams across threads.  Every group runs on the device's default stream
(a pool thread's current stream): kernels of two concurrent groups
serialize on the card while their host work — staging, dispatch, the
fill of each group's own prefetcher, which takes that same stream as its
compute stream — overlaps.  A stream of its own per group would let the
kernels overlap too, at the price of building each prefetcher inside that
stream's context and making every result safe for the caller's stream
(``wait_stream`` / ``record_stream``); the kernels of the main path are
bound by the card's memory, so two of them gain little from running at
once.  A request's future resolves only after its group's device work has
finished: the worker thread synchronizes an event recorded on the
group's compute stream after the epilogue, and the thread that registers
the results does the same after registering them.  ``result()`` then
hands out finished tensors to any thread on any stream, and
``serve_request_seconds`` measures completion, not enqueue.

Per-request futures resolve only after every pass of that request
succeeded; a failing group fails its members' futures and registers no
partial sinks (the fm.batch contract).  ``fm.collect_stats()`` scopes open
at submit time travel with the request, so each tenant sees its OWN
plan's passes and bytes, not the group's.  Sharded groups (``mesh=``)
come with the multi-GPU slice (ROADMAP A13).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time
from typing import Optional

import torch

from . import batch as batch_mod
from . import lowering
from . import materialize as mz
from .fusion import coschedule
from .matrix import FMMatrix
from ..observability import metrics
from ..observability.trace import TRACER

#: Floor of the 'auto' in-flight-bytes cap: even a slow measured tier
#: admits at least this much concurrently, so tiny test matrices never
#: serialize spuriously.
MIN_INFLIGHT_BYTES = 32 << 20


class EngineSaturated(RuntimeError):
    """`Engine.submit` backpressure: the pending queue held
    ``max_pending_requests`` for the whole ``submit_timeout_s`` wait.  The
    request was NOT enqueued; retry later or raise the cap."""


class ServeRequest(batch_mod.BatchRequest):
    """One submitted request: a BatchRequest plus its future and timing."""

    def __init__(self, outputs, *, structured: bool):
        super().__init__(outputs, structured=structured)
        self.future: "concurrent.futures.Future" = concurrent.futures.Future()
        self.t_submit = time.perf_counter()
        self.failed = False


class RequestHandle:
    """The caller's side of a submitted request."""

    def __init__(self, req: ServeRequest):
        self._req = req

    def result(self, timeout: Optional[float] = None):
        """Block until the request's results are registered; returns one
        physical FMMatrix (or a list, mirroring a multi-output submit),
        whose device work has finished.  Raises whatever failed the
        request's group."""
        return self._req.future.result(timeout)

    def done(self) -> bool:
        return self._req.future.done()

    def exception(self, timeout: Optional[float] = None):
        return self._req.future.exception(timeout)


class _Gate:
    """Mid-stream admission point of one LIVE streaming group.

    ``offer`` (submit thread) parks a compatible late request; ``take``
    (the group's worker, at each partition boundary through the
    `_run_stream_group` ``admit`` hook) splices the parked members into the
    sweep.  ``close`` returns requests offered too late to be taken — the
    engine re-queues them for the next window."""

    def __init__(self, long_dim: int, rows: int, source_ids: frozenset,
                 to_host: bool):
        self.long_dim = long_dim
        self.rows = rows
        self.source_ids = source_ids
        self.to_host = to_host
        self._lock = threading.Lock()
        self._pending: list = []    # [(req, member)] offered, not yet taken
        self.admitted: list = []    # [(req, member)] riding the sweep
        self._closed = False

    def accepts(self, req: ServeRequest) -> bool:
        """Static compatibility: single-pass, same long dimension, staged
        sources a subset of the group's, partition rows no finer than the
        group's sweep, and long-dimension outputs row-addressed (host or
        disk) — the constraints `materialize._join_member` enforces."""
        if req.n_passes != 1:
            return False
        ps = req.plan.passes[0]
        if ps.long_dim != self.long_dim or ps.partition_rows < self.rows:
            return False
        srcs = [m for _, m in req.plan.sources]
        if not {id(m) for _, m in ps.staged_sources(srcs)} <= self.source_ids:
            return False
        outs = ps.row_local_roots + ps.saves
        default = "host" if self.to_host else "device"
        return all((n.save or default) != "device" for n in outs)

    def offer(self, req: ServeRequest, member) -> bool:
        with self._lock:
            if self._closed:
                return False
            self._pending.append((req, member))
            return True

    def take(self, start: int, stop: int) -> list:
        with self._lock:
            taken, self._pending = self._pending, []
            self.admitted.extend(taken)
            return [member for _, member in taken]

    def close(self) -> list:
        """Seal the gate; returns requests offered but never taken."""
        with self._lock:
            self._closed = True
            leftover, self._pending = self._pending, []
            return [req for req, _ in leftover]


class Engine:
    """fm.serve / fm.Engine: the admission-controlled request scheduler.

    Parameters
    ----------
    window_ms : float
        Admission window: how long the scheduler holds the first request
        of a window open for same-source company (default 5 ms).
    max_window_requests : int or None
        Close the window early once this many requests are pending —
        deterministic batching for load generators and tests.
    max_concurrent_streams : int
        Worker pool size: how many co-scheduled groups may stream at once.
    max_inflight_bytes : int, None or 'auto'
        Admission control on the staging tier: a group whose union staged
        bytes would push the in-flight total past the cap waits
        (``serve_deferrals`` / ``serve_admission_wait_seconds``).  'auto'
        derives the cap from the measured staging rate (≈
        ``bandwidth_window_s`` seconds of reads, ≥ MIN_INFLIGHT_BYTES);
        None disables the cap.  At least one group is always admitted, so
        the cap can never deadlock.
    max_pending_requests : int or None
        Submitter backpressure: a ``submit()`` that finds the pending
        queue full blocks up to ``submit_timeout_s`` for the scheduler to
        drain a window, then raises `EngineSaturated`
        (``serve_rejections``).  None (default) leaves the queue unbounded.
    submit_timeout_s : float
        How long a blocked ``submit()`` waits for queue space (default 0:
        reject at once when full).
    midstream_admission : bool
        Let late same-group plans join a live sweep at the next partition
        boundary (default True).
    mode / backend / donate / prefetch / reuse_plans
        Per-group execution knobs, following ``fm.materialize``
        (``donate`` has no effect there or here).
    prefetch_depth : int or None
        Override the group-aware negotiated prefetch depth.
    mesh
        None only: sharded serving comes with ROADMAP A13.
    """

    def __init__(self, *, window_ms: float = 5.0,
                 max_window_requests: Optional[int] = None,
                 max_concurrent_streams: int = 2,
                 max_inflight_bytes="auto",
                 bandwidth_window_s: float = 0.25,
                 max_pending_requests: Optional[int] = None,
                 submit_timeout_s: float = 0.0,
                 midstream_admission: bool = True,
                 mode: str = "auto", backend: Optional[str] = None,
                 donate: bool = True, prefetch: Optional[bool] = None,
                 prefetch_depth: Optional[int] = None,
                 reuse_plans: bool = True, mesh=None):
        batch_mod._no_mesh(mesh)
        from ..storage import registry
        self.device = registry.device()  # raises when CUDA is absent
        self.window_s = max(float(window_ms), 0.0) / 1e3
        self.max_window_requests = (int(max_window_requests)
                                    if max_window_requests else None)
        self.max_inflight_bytes = max_inflight_bytes
        self.bandwidth_window_s = float(bandwidth_window_s)
        self.max_pending_requests = (int(max_pending_requests)
                                     if max_pending_requests else None)
        self.submit_timeout_s = max(float(submit_timeout_s), 0.0)
        self.midstream_admission = bool(midstream_admission)
        self.mode = mode
        self.backend = lowering.resolve_backend(backend)
        self.prefetch = prefetch
        self.prefetch_depth = prefetch_depth
        self.reuse_plans = reuse_plans

        self._cv = threading.Condition()
        self._pending: list[ServeRequest] = []
        self._closed = False
        self._gates: list[_Gate] = []
        self._gates_lock = threading.Lock()
        self._bw_cv = threading.Condition()
        self._inflight_bytes = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(max_concurrent_streams)),
            thread_name_prefix="fm-serve")
        self._scheduler = threading.Thread(
            target=self._schedule_loop, name="fm-serve-scheduler",
            daemon=True)
        self._scheduler.start()

    # -- submission ----------------------------------------------------------
    def submit(self, *outputs) -> RequestHandle:
        """Submit one request (what would otherwise be one
        ``fm.materialize(*outputs)`` call) from any thread; returns a
        future-like `RequestHandle`.  The request's plan is built here, on
        the caller's thread, under the caller's open ``fm.collect_stats()``
        scopes."""
        if self._closed:
            raise RuntimeError("engine is closed")
        mats = [getattr(x, "m", x) for x in outputs]
        for m in mats:
            if not isinstance(m, FMMatrix):
                raise TypeError(f"submit() takes lazy matrices, got {m!r}")
        req = ServeRequest(mats, structured=len(mats) != 1)
        metrics.inc("serve_requests")
        if not batch_mod._plan_request(req, self.backend, self.reuse_plans):
            # Pure pass-through: every output is already physical.
            req.future.set_result(
                req.results() if req.structured else req.results()[0])
            return RequestHandle(req)
        if self.midstream_admission and self._try_midstream(req):
            return RequestHandle(req)
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            # Submitter backpressure: wait for a window to drain up to
            # submit_timeout_s, then reject.
            if self.max_pending_requests is not None:
                deadline = time.perf_counter() + self.submit_timeout_s
                while (len(self._pending) >= self.max_pending_requests
                       and not self._closed):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        metrics.inc("serve_rejections")
                        raise EngineSaturated(
                            f"pending queue full "
                            f"({self.max_pending_requests} requests) for "
                            f"{self.submit_timeout_s:g}s")
                    self._cv.wait(timeout=left)
                if self._closed:
                    raise RuntimeError("engine is closed")
            self._pending.append(req)
            metrics.observe("serve_queue_depth", len(self._pending))
            self._cv.notify_all()
        return RequestHandle(req)

    def _try_midstream(self, req: ServeRequest) -> bool:
        """Offer ``req`` to a live compatible gate; True when parked."""
        with self._gates_lock:
            gate = next((g for g in self._gates if g.accepts(req)), None)
            if gate is None:
                return False
            member = batch_mod._member_for(req, 0)
            return gate.offer(req, member)

    # -- scheduler thread ----------------------------------------------------
    def _schedule_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                # Admission window: hold the first request open for
                # same-source company, close early on max_window_requests.
                deadline = time.perf_counter() + self.window_s
                while not self._closed:
                    if (self.max_window_requests is not None
                            and len(self._pending) >= self.max_window_requests):
                        break
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                window, self._pending = self._pending, []
                # Wake submitters blocked on max_pending_requests: the
                # queue just drained.
                self._cv.notify_all()
            try:
                self._run_window(window)
            except Exception as exc:  # noqa: BLE001 - fail the window, not the loop
                for req in window:
                    req.failed = True
                    if not req.future.done():
                        req.future.set_exception(exc)

    def _run_window(self, window: list):
        metrics.inc("serve_windows")
        metrics.observe("serve_window_requests", len(window))
        active = [req for req in window if not req.failed]
        n_rounds = max((req.n_passes for req in active), default=0)
        stream_bytes: list[int] = []
        with TRACER.span("serve_window", requests=len(active),
                         rounds=n_rounds):
            for r in range(n_rounds):
                live = [req for req in active
                        if not req.failed and r < req.n_passes]
                if not live:
                    break
                keys = [batch_mod.pass_group_key(req, r) for req in live]
                futs = []
                for group in coschedule(keys):
                    reqs = [live[i] for i in group]
                    futs.append(self._pool.submit(
                        self._run_group, reqs, r, stream_bytes))
                for f in futs:
                    exc = f.exception()
                    if exc is not None:  # _run_group failed outside its guard
                        for req in live:
                            if not req.future.done():
                                req.failed = True
                                req.future.set_exception(exc)
        # Root + ambient scopes see the PHYSICAL traffic: one entry per
        # stream group driven in this window.
        metrics.put("pass_bytes_in", tuple(stream_bytes))
        for req in active:
            if req.failed or req.future.done():
                continue
            self._finish_request(req)

    # -- group execution (worker pool) ---------------------------------------
    def _run_group(self, reqs: list, r: int, stream_bytes: list):
        members = [batch_mod._member_for(req, r) for req in reqs]
        union, seen = [], set()
        for m in members:
            for _, mat in m.ps.staged_sources(m.sources):
                if id(mat) not in seen:
                    seen.add(id(mat))
                    union.append(mat)
        union_bytes = sum(mat.nbytes() for mat in union)
        stream_bytes.append(union_bytes)
        group_mode = mz._pick_mode_src(union, self.mode)
        if group_mode not in ("whole", "stream", "ooc"):
            raise ValueError(f"unknown mode {group_mode!r}")

        gate = None
        self._acquire_bandwidth(union_bytes)
        try:
            with self._on_device(), \
                    TRACER.span("serve_group", members=len(members),
                                round=r, mode=group_mode):
                if group_mode == "whole":
                    mz._run_whole_group(members)
                else:
                    admit = None
                    if self.midstream_admission and r == 0:
                        gate = self._open_gate(members, group_mode)
                        admit = gate.take
                    mz._run_stream_group(
                        members, to_host=(group_mode == "ooc"),
                        prefetch=self.prefetch, capture=False, admit=admit,
                        depth=self.prefetch_depth)
                # Completion, not enqueue: the group's kernels and epilogue
                # have run before any member's future can resolve.
                self._wait_device()
            admitted = gate.admitted if gate is not None else []
            pairs = list(zip(members, reqs)) + [(m, req)
                                                for req, m in admitted]
            for m, req in pairs:
                if group_mode == "ooc":
                    req.to_host = True
                req.pass_bytes.append(m.ps.bytes_in(m.sources))
                req.finals.update(m.finals)
                req.parts.update(m.out_parts)
                req.epi.update(m.epi_outs)
                req.disk.update(m.disk_stores)
                req.carried.update(m.finals)
                req.carried.update(m.epi_outs)
            # Mid-admitted requests are single-pass: resolve them now.
            for req, _ in admitted:
                self._finish_request(req)
        except Exception as exc:  # noqa: BLE001 - fail the group's members only
            admitted = gate.admitted if gate is not None else []
            for req in list(reqs) + [rq for rq, _ in admitted]:
                req.failed = True
                if not req.future.done():
                    req.future.set_exception(exc)
        finally:
            if gate is not None:
                self._close_gate(gate)
            self._release_bandwidth(union_bytes)

    def _on_device(self):
        """The engine's card as the worker's current device (a new thread's
        is card 0): staging and the kernels' launches go to it."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _wait_device(self):
        """Block this thread until the work queued on its current stream of
        the engine's card has run (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def _finish_request(self, req: ServeRequest):
        """Register the request's results onto its own plan and resolve its
        future (the batch `_store_results(onto=)` discipline), once the
        device work registration queued (a concatenation of partitions)
        has run."""
        try:
            ambient = set(metrics.REGISTRY.scopes())
            for sc in req.scopes:
                if sc not in ambient:
                    sc.put("pass_bytes_in", tuple(req.pass_bytes))
            mz._store_results(req.exec_plan, req.finals, req.parts,
                              to_host=req.to_host, disk_stores=req.disk,
                              epilogue_outs=req.epi, onto=req.plan)
            res = req.results()
            self._wait_device()
            metrics.observe("serve_request_seconds",
                            time.perf_counter() - req.t_submit)
            req.future.set_result(res if req.structured else res[0])
        except Exception as exc:  # noqa: BLE001
            req.failed = True
            if not req.future.done():
                req.future.set_exception(exc)

    # -- mid-stream gates ----------------------------------------------------
    def _open_gate(self, members, group_mode: str) -> _Gate:
        source_ids = frozenset(
            id(mat) for m in members
            for _, mat in m.ps.staged_sources(m.sources))
        gate = _Gate(members[0].ps.long_dim,
                     min(m.ps.partition_rows for m in members),
                     source_ids, to_host=(group_mode == "ooc"))
        with self._gates_lock:
            self._gates.append(gate)
        return gate

    def _close_gate(self, gate: _Gate):
        with self._gates_lock:
            if gate in self._gates:
                self._gates.remove(gate)
        leftover = gate.close()
        if not leftover:
            return
        # Offered after the sweep's last boundary: back to the queue for
        # the next window (never dropped, never half-admitted).
        with self._cv:
            self._pending.extend(leftover)
            self._cv.notify_all()

    # -- bandwidth admission control -----------------------------------------
    def _current_cap(self) -> Optional[int]:
        cap = self.max_inflight_bytes
        if cap is None:
            return None
        if cap == "auto":
            root = metrics.REGISTRY.root
            read_s = root.counter("stage_read_seconds")
            if read_s <= 0:
                return None  # no telemetry yet: first groups calibrate
            bw = root.counter("stage_bytes_read") / read_s
            return max(int(bw * self.bandwidth_window_s),
                       MIN_INFLIGHT_BYTES)
        return int(cap)

    def _acquire_bandwidth(self, nbytes: int):
        with self._bw_cv:
            cap = self._current_cap()
            if (cap is not None and self._inflight_bytes > 0
                    and self._inflight_bytes + nbytes > cap):
                metrics.inc("serve_deferrals")
                t0 = time.perf_counter()
                with TRACER.span("admission_wait", nbytes=nbytes, cap=cap):
                    # A group is always admitted once the tier is idle, so
                    # a cap smaller than one group cannot deadlock.
                    while self._inflight_bytes > 0:
                        cap = self._current_cap()
                        if cap is None or \
                                self._inflight_bytes + nbytes <= cap:
                            break
                        self._bw_cv.wait(timeout=0.05)
                metrics.inc("serve_admission_wait_seconds",
                            time.perf_counter() - t0)
            self._inflight_bytes += nbytes
            metrics.observe("serve_inflight_bytes", self._inflight_bytes)

    def _release_bandwidth(self, nbytes: int):
        with self._bw_cv:
            self._inflight_bytes -= nbytes
            self._bw_cv.notify_all()

    # -- lifecycle -----------------------------------------------------------
    def stats(self) -> dict:
        """Root-scope serving metrics: serve_* counters/histograms plus
        ``midstream_admits``."""
        st = metrics.REGISTRY.root.stats()
        out = {k: v for k, v in st.items() if k.startswith("serve_")}
        out["midstream_admits"] = int(st.get("midstream_admits", 0))
        return out

    def close(self, release_storage: bool = False):
        """Drain every pending request, stop the scheduler, shut the pool
        down.  Idempotent; the context-manager exit calls it.
        ``release_storage=True`` also removes every registry-OWNED lazily
        created data dir (`storage.registry.cleanup`) — never a
        user-configured ``data_dir``."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._scheduler.join(timeout=60.0)
        self._pool.shutdown(wait=True)
        if release_storage:
            from ..storage import registry
            registry.cleanup()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def serve(**kw) -> Engine:
    """fm.serve: start an `Engine` (see its docstring for the knobs).

        with fm.serve(window_ms=5) as eng:
            h1 = eng.submit(fm.colMeans(X))   # any thread
            h2 = eng.submit(fm.crossprod(X))  # same window, same stream
            mu, G = h1.result(), h2.result()
    """
    return Engine(**kw)
