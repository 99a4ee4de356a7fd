"""Cross-materialize stream fusion: the batch execution layer (PyTorch port
of repro.core.batch).

A solo ``fm.materialize`` fuses one plan into the fewest passes, but
independent plans over the same physical matrix each pay their own scan.
``fm.batch`` schedules passes across plans:

  1. every request's lazy outputs build their own `fusion.Plan` (own
     plan-cache entry, own sinks and epilogue — nothing about a plan
     changes);
  2. round r collects pass r of every unfinished plan and co-schedules the
     passes by `fusion.stream_group_key` — shared physical sources, same
     long dimension (a pass whose source set is a subset of another's rides
     that group's stream);
  3. each group runs as one streaming drive (`materialize._run_stream_group`;
     `lowering.GroupProgram` describes the composition): while a staged
     partition is resident, every member's ``step`` consumes it — on a
     card, each member's hand-written kernels one after another on the
     compute stream — and folds its partials through its own ``combine``
     before the partition is dropped: k plans × 1 stream becomes 1 stream
     × k steps (``exec_stats()['streams']``).

Results register only after every round of every member succeeds: an
interrupted group (a staging fault mid-stream) leaves no partially
registered sinks behind for any member.  Per-request metrics scopes are
captured when the request joins the batch, so ``fm.collect_stats()``
around one request reports that plan's own pass and byte share rather
than the whole group's.

Consecutive rounds with identical partition schedules reuse the resident
final partition (``prefetch_reuse_hits``), and inside
``materialize.iteration_scope`` the residency carries across batches and
materializes.  Sharded groups (``mesh=``) come with the multi-GPU slice
(ROADMAP A13).
"""
from __future__ import annotations

import time
from typing import Optional

from . import lowering
from . import materialize as mz
from .fusion import Plan, coschedule, stream_group_key
from .matrix import FMMatrix
from ..observability import metrics
from ..observability.trace import TRACER


class BatchRequest:
    """One member of a batch: the lazy outputs of what would otherwise be
    its own ``fm.materialize(*outputs)`` call, plus the metrics scopes
    open when it was added (per-request attribution)."""

    def __init__(self, outputs, *, structured: bool):
        self.outputs = list(outputs)
        self.structured = structured  # result mirrors a tuple/list request
        self.scopes = metrics.current_scopes()
        # Execution state (filled by execute_batch).
        self.plan: Optional[Plan] = None
        self.exec_plan: Optional[Plan] = None
        self.pass_progs = None
        self.carried: dict[int, object] = {}
        self.finals: dict[int, object] = {}
        self.parts: dict[int, list] = {}
        self.epi: dict[int, object] = {}
        self.disk: dict[int, object] = {}
        self.pass_bytes: list[int] = []
        self.to_host = False

    @property
    def n_passes(self) -> int:
        return len(self.plan.passes) if self.plan is not None else 0

    def results(self) -> list[FMMatrix]:
        return [mz._result_of(m) for m in self.outputs]


def _request_stack(req: BatchRequest):
    """Executor-thread scopes + the request's captured scopes, deduped —
    the stack request-level counters (materialize_calls, cache hits,
    pass_bytes_in) record under."""
    cur = metrics.current_scopes()
    extra = [s for s in req.scopes if s not in set(cur)]
    return tuple(cur) + tuple(extra)


def _plan_request(req: BatchRequest, backend: str,
                  reuse_plans: bool) -> bool:
    """Build ``req``'s own Plan and acquire its (possibly cached) template.
    False for a pure pass-through request (no virtual outputs).  Plan
    construction classifies live DAG node state, so it runs under
    materialize's _DAG_LOCK."""
    virtuals = [m for m in req.outputs if m.is_virtual]
    if not virtuals:
        return False
    with metrics.use_scopes(_request_stack(req)):
        metrics.inc("materialize_calls")
        with mz._DAG_LOCK:
            req.plan = Plan(virtuals)
            req.exec_plan = mz._acquire_exec_plan(req.plan, backend,
                                                  reuse_plans)
    prog = req.exec_plan.program(backend)
    req.pass_progs = getattr(prog, "passes", None) or [prog]
    return True


def pass_group_key(req: BatchRequest, r: int) -> tuple:
    """The co-schedule key of request ``req``'s pass ``r``: its
    `fusion.stream_group_key` over the request's own source matrices."""
    own_ps = req.plan.passes[r]
    src_off = sum(len(p.sources) for p in req.plan.passes[:r])
    srcs = [m for _, m in req.plan.sources][
        src_off:src_off + len(own_ps.sources)]
    return stream_group_key(own_ps, srcs)


def _member_for(req: BatchRequest, r: int):
    """The `_PassExec` of request ``req``'s pass ``r``: the template's
    PassSchedule and program (the possibly borrowed cached plan) driven
    with the request's own matrices, save specs and carried bindings."""
    own, tmpl = req.plan, req.exec_plan
    own_ps, exec_ps = own.passes[r], tmpl.passes[r]
    src_off = sum(len(p.sources) for p in own.passes[:r])
    bc_off = sum(len(p.broadcast_sources) for p in own.passes[:r])
    epi_off = sum(len(p.epilogue_sources) for p in own.passes[:r])
    sources = [m for _, m in own.sources][
        src_off:src_off + len(own_ps.sources)]
    bc = [m for _, m in own.broadcast_sources][
        bc_off:bc_off + len(own_ps.broadcast_sources)]
    epi = [m for _, m in own.epilogue_sources][
        epi_off:epi_off + len(own_ps.epilogue_sources)]
    bindings = {nid: req.carried[nid] for nid in exec_ps.binding_ids}
    for nid, mat in exec_ps.broadcast_source_pairs(bc):
        bindings[nid] = mz._stage_whole(mat)
    out_nodes = list(zip(exec_ps.row_local_roots + exec_ps.saves,
                         own_ps.row_local_roots + own_ps.saves))
    return mz._PassExec(exec_ps, req.pass_progs[r], sources,
                        own.small_values(), epi, bindings,
                        out_nodes=out_nodes, scopes=req.scopes)


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution across cards comes with the multi-GPU slice "
            "(ROADMAP A13)")


def plan_rounds(requests, *, backend: Optional[str] = None,
                reuse_plans: bool = True, mesh=None):
    """Prepare every request's plan and the per-round co-schedule.

    Returns ``(active_requests, rounds)`` where each round is a list of
    groups and each group a list of (request, pass index) pairs — the
    deterministic schedule both `execute_batch` and ``fm.explain_batch``
    read.  Requests whose outputs are all physical come back with
    ``plan is None`` (pure pass-through)."""
    _no_mesh(mesh)
    backend = lowering.resolve_backend(backend)
    active = [req for req in requests
              if _plan_request(req, backend, reuse_plans)]

    rounds = []
    n_rounds = max((req.n_passes for req in active), default=0)
    for r in range(n_rounds):
        live = [req for req in active if r < req.n_passes]
        keys = [pass_group_key(req, r) for req in live]
        rounds.append([[(live[i], r) for i in group]
                       for group in coschedule(keys)])
    return active, rounds


def execute_batch(requests, *, mode: str = "auto",
                  backend: Optional[str] = None, donate: bool = True,
                  prefetch: Optional[bool] = None, reuse_plans: bool = True,
                  mesh=None):
    """Execute every request, one streaming drive per co-scheduled group.

    Returns the requests' result lists (physical FMMatrix per output).
    ``mode`` follows ``fm.materialize`` ('auto' picks per group from the
    union of that group's sources); ``donate`` is accepted and has no
    effect, as in ``materialize``.  A failure mid-batch clears the thread's
    resident-partition capture: residents from a previous round must not
    stay held for the rest of the iteration scope."""
    _no_mesh(mesh)
    from ..storage import registry
    registry.device()  # raises when CUDA is asked for and absent
    try:
        return _execute_batch(requests, mode=mode, backend=backend,
                              prefetch=prefetch, reuse_plans=reuse_plans)
    except BaseException:
        mz._set_tls_residents(None)
        raise


def _execute_batch(requests, *, mode, backend, prefetch, reuse_plans):
    backend = lowering.resolve_backend(backend)
    active, rounds = plan_rounds(requests, backend=backend,
                                 reuse_plans=reuse_plans)
    residents = mz._tls_residents()
    stream_bytes: list[int] = []
    with TRACER.span("batch", requests=len(active), rounds=len(rounds)):
        for r, groups in enumerate(rounds):
            next_residents = []
            for group in groups:
                members = [_member_for(req, rr) for req, rr in group]
                union = []
                seen = set()
                for m in members:
                    for _, mat in m.ps.staged_sources(m.sources):
                        if id(mat) not in seen:
                            seen.add(id(mat))
                            union.append(mat)
                stream_bytes.append(sum(mat.nbytes() for mat in union))
                group_mode = mz._pick_mode_src(union, mode)
                if group_mode not in ("whole", "stream", "ooc"):
                    raise ValueError(f"unknown mode {group_mode!r}")
                t_pass = time.perf_counter()
                if group_mode == "whole":
                    mz._run_whole_group(members)
                else:
                    capture = mz.inspecting() or r + 1 < len(rounds)
                    entry = mz._run_stream_group(
                        members, to_host=(group_mode == "ooc"),
                        prefetch=prefetch, residents=residents,
                        capture=capture)
                    if entry is not None:
                        next_residents.append(entry)
                metrics.inc("pass_seconds", time.perf_counter() - t_pass)
                for m, (req, _) in zip(members, group):
                    if group_mode == "ooc":
                        req.to_host = True
                    req.pass_bytes.append(m.ps.bytes_in(m.sources))
                    req.finals.update(m.finals)
                    req.parts.update(m.out_parts)
                    req.epi.update(m.epi_outs)
                    req.disk.update(m.disk_stores)
                    req.carried.update(m.finals)
                    req.carried.update(m.epi_outs)
            residents = next_residents or None
    mz._set_tls_residents(residents)

    # Root + the executor's ambient scopes see the physical traffic: one
    # entry per stream group with that group's union bytes.  Each request's
    # own scopes see their plan's per-pass bytes, what a solo materialize
    # of that request would have reported.
    metrics.put("pass_bytes_in", tuple(stream_bytes))
    ambient = set(metrics.REGISTRY.scopes())
    for req in active:
        for sc in req.scopes:
            if sc not in ambient:
                sc.put("pass_bytes_in", tuple(req.pass_bytes))

    # Every round of every member succeeded: register results.  Values are
    # keyed by the template plan's node ids but land on each request's own
    # nodes (onto=), so a borrowed cache template is never written: two
    # requests borrowing one template cannot overwrite each other's results.
    for req in active:
        mz._store_results(req.exec_plan, req.finals, req.parts,
                          to_host=req.to_host, disk_stores=req.disk,
                          epilogue_outs=req.epi, onto=req.plan)
    return [req.results() for req in requests]


class Batch:
    """Collector form of ``fm.batch``: queue requests, run them together.

        with fm.batch() as b:
            h1 = b.add(fm.colMeans(X))
            h2 = b.add(fm.colSds(X), fm.crossprod(X))
        h1.value, h2.value

    ``add`` captures the thread's open ``fm.collect_stats()`` scopes with
    the request; ``run`` (or context exit) executes every queued request
    in co-scheduled groups."""

    def __init__(self, *, mode: str = "auto", backend: Optional[str] = None,
                 donate: bool = True, prefetch: Optional[bool] = None,
                 reuse_plans: bool = True, mesh=None):
        _no_mesh(mesh)
        self._kw = dict(mode=mode, backend=backend, donate=donate,
                        prefetch=prefetch, reuse_plans=reuse_plans)
        self.requests: list[BatchRequest] = []
        self._ran = False

    def add(self, *outputs) -> "BatchHandle":
        if self._ran:
            raise RuntimeError("batch already executed")
        structured = len(outputs) != 1
        req = BatchRequest(outputs, structured=structured)
        self.requests.append(req)
        return BatchHandle(req)

    def run(self) -> list:
        if self._ran:
            raise RuntimeError("batch already executed")
        self._ran = True
        results = execute_batch(self.requests, **self._kw)
        return [res if req.structured else res[0]
                for req, res in zip(self.requests, results)]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and not self._ran:
            self.run()
        return False


class BatchHandle:
    """A queued request's result slot (``Batch.add``)."""

    def __init__(self, req: BatchRequest):
        self._req = req

    @property
    def value(self):
        res = self._req.results()
        return res if self._req.structured else res[0]
