"""Materialization engine (paper §III-F), PyTorch port of
repro.core.materialize — ``whole`` mode over the device tier.

``whole`` runs the entire long dimension as one partition through each
pass's lowered step: the kernels stream the rows themselves.  It is what
``mode="auto"`` resolves to for device-resident data.  Sinks merge with the
aggregation VUDFs' ``combine``, each pass runs its epilogue once after the
merge, and results register only after every pass has run.  The plan cache
(LRU, under locks), the execution counters and the iteration scope are the
reference's.

Not in this slice: ``stream``/``ooc`` modes, host-tier staging and prefetch
(ROADMAP A7), co-scheduled groups (``fm.batch``, ROADMAP A11) and shards
(ROADMAP A13).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from . import lowering
from .dag import Node, wrap
from .fusion import Plan
from .matrix import DenseStore, FMMatrix
from ..observability import metrics
from ..observability.trace import TRACER

_STREAM_MODES = ("the stream and ooc modes, with host-tier staging and "
                 "prefetch, come with the disk-tier slice (ROADMAP A7)")

# Plan cache: structurally identical DAG cuts (k-means iteration N+1, IRLS
# steps) reuse one lowered program.  Keyed by signature + partition
# schedule + backend, LRU-evicted at PLAN_CACHE_LIMIT.
_PLANS: "OrderedDict" = OrderedDict()
PLAN_CACHE_LIMIT = 256

# _PLANS_LOCK guards the cache dict; _DAG_LOCK serializes plan construction
# and result registration, the two operations that touch live DAG node
# state (see the reference for the full argument).
_PLANS_LOCK = threading.Lock()
_DAG_LOCK = threading.RLock()

#: The counters ``exec_stats()`` exposes (the reference's list; the stream,
#: shard and admission counters stay 0 in whole mode).
EXEC_COUNTERS = (
    "materialize_calls",
    "plan_cache_hits",
    "plan_cache_misses",
    "partition_steps",
    "passes",
    "streams",
    "shards",
    "shard_merges",
    "midstream_admits",
    "prefetch_reuse_hits",
    "epilogue_launches",
    "epilogue_host_inputs",
)


def exec_stats() -> dict:
    """Snapshot of the engine's execution counters plus ``pass_bytes_in``:
    the per-pass streamed bytes of the last execution."""
    st = {k: int(metrics.root_counter(k)) for k in EXEC_COUNTERS}
    st["pass_bytes_in"] = tuple(metrics.root_value("pass_bytes_in", ()))
    st["shard_bytes_in"] = tuple(metrics.root_value("shard_bytes_in", ()))
    return st


def reset_exec_stats():
    metrics.REGISTRY.reset()


def clear_plan_cache():
    with _PLANS_LOCK:
        _PLANS.clear()


def _sync():
    """Wait for the card: only while tracing, for span timing fidelity."""
    if TRACER.enabled and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def materialize(*mats: FMMatrix, mode: str = "auto", fuse: bool = True,
                mesh=None, reuse_plans: bool = True,
                backend: Optional[str] = None) -> list[FMMatrix]:
    """fm.materialize: force computation of virtual matrices; one physical
    FMMatrix per argument (physical arguments pass through).  Multiple
    arguments materialize together in one fused pass.  ``backend`` is
    'torch' | 'cuda' | 'auto' (None = ``fm.set_conf(backend=...)``)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution across cards comes with the multi-GPU slice "
            "(ROADMAP A13)")
    from ..storage import registry
    registry.device()  # raises when CUDA is asked for and absent
    virtuals = [m for m in mats if m.is_virtual]
    if not virtuals:
        return list(mats)

    metrics.inc("materialize_calls")
    backend = lowering.resolve_backend(backend)

    if not fuse:
        with TRACER.span("materialize", backend=backend, fuse=False,
                         outputs=len(virtuals)):
            _materialize_eager([m.node for m in virtuals], mode=mode,
                               backend=backend)
        return [_result_of(m) for m in mats]

    with _DAG_LOCK:
        plan = Plan(virtuals)
        exec_plan = _acquire_exec_plan(plan, backend, reuse_plans)

    # A cached plan's nodes belong to the first caller's DAG: execution reads
    # the template's programs and registers results onto THIS call's nodes.
    with TRACER.span("materialize", backend=backend,
                     passes=plan.n_passes, outputs=len(virtuals),
                     cached=exec_plan is not plan):
        _execute_passes(exec_plan, onto=plan, mode=mode,
                        sources=[m for _, m in plan.sources],
                        bc_sources=[m for _, m in plan.broadcast_sources],
                        epi_sources=[m for _, m in plan.epilogue_sources],
                        smalls=plan.small_values(), backend=backend)
    return [_result_of(m) for m in mats]


def _result_of(m: FMMatrix) -> FMMatrix:
    if not m.is_virtual:
        return m
    store = getattr(m.node, "cached_store", None)
    if store is None:
        raise RuntimeError(f"{m.node} failed to materialize")
    return store


def _acquire_exec_plan(plan: Plan, backend: str, reuse_plans: bool):
    """Plan-cache lookup: signature, both partition levels of every pass
    and the backend form the key.  Thread-safe under _PLANS_LOCK."""
    if not reuse_plans:
        return plan
    sig = (plan.signature(), plan.pass_key(), backend)
    with _PLANS_LOCK:
        cached = _PLANS.get(sig)
        if cached is not None:
            metrics.inc("plan_cache_hits")
            _PLANS.move_to_end(sig)
            return cached
        metrics.inc("plan_cache_misses")
        _PLANS[sig] = plan
        while len(_PLANS) > PLAN_CACHE_LIMIT:
            _PLANS.popitem(last=False)
        return plan


# ---------------------------------------------------------------------------
# Iteration inspector
# ---------------------------------------------------------------------------

_INSPECT = threading.local()


def inspecting() -> bool:
    """True while an ``iteration_scope`` is open on this thread."""
    return getattr(_INSPECT, "depth", 0) > 0


@contextlib.contextmanager
def iteration_scope():
    """fm.inspect_iterations: declare an iterative driver's loop.  In whole
    mode every pass reads the resident source itself, so there is no staged
    partition to keep across calls; the scope is tracked so the drivers run
    with their default ``inspect=True`` (partition reuse across calls comes
    with the streaming modes, ROADMAP A11)."""
    _INSPECT.depth = getattr(_INSPECT, "depth", 0) + 1
    try:
        yield
    finally:
        _INSPECT.depth -= 1


# ---------------------------------------------------------------------------
# Fused execution
# ---------------------------------------------------------------------------

def _run_whole_group(ps, prog, sources, smalls, epi_sources, bindings):
    """Whole-mode sweep of one pass: its staged sources are the device
    tensors themselves — a sparse source its ELL slab as one ``SparseBlock``,
    never densified — and the step consumes them as one partition (offset
    0).  Returns (finalized sinks, long-dimension outputs, epilogue outputs).
    """
    blocks = {nid: (mat.block(0, mat.nrow) if mat.is_sparse
                    else mat.logical_data())
              for nid, mat in ps.staged_sources(sources)}
    long_dim = ps.long_dim
    metrics.inc("streams")
    metrics.inc("bytes_streamed", sum(mat.nbytes() for _, mat in
                                      ps.staged_sources(sources)))
    metrics.inc("passes")
    accs = ps.init_accs()
    with TRACER.span("stream", members=1, mode="whole"):
        with TRACER.span("partition", start=0, stop=long_dim):
            metrics.inc("partition_steps")
            t0 = time.perf_counter()
            with TRACER.span("device_step", rows=long_dim, member=0):
                partials, outputs = prog.step(blocks, smalls, bindings, 0)
                _sync()
            metrics.inc("device_step_seconds", time.perf_counter() - t0)
            t0 = time.perf_counter()
            with TRACER.span("combine", member=0):
                accs = prog.combine(accs, partials)
                _sync()
            metrics.inc("combine_seconds", time.perf_counter() - t0)
    finals = ps.finalize_accs(accs)
    epi_outs = _run_epilogue(ps, prog, finals, epi_sources, smalls, bindings)
    return finals, outputs, epi_outs


def _execute_passes(plan: Plan, *, onto: Optional[Plan] = None,
                    mode: str = "auto", sources=None, smalls=None,
                    backend: Optional[str] = None,
                    epi_sources=None, bc_sources=None):
    """Run every pass of ``plan`` in order, carrying each pass's merged
    sinks and epilogue outputs forward as the next pass's bindings, then
    register the results (only after every pass has succeeded).  ``onto``
    is the caller's own equal-signature plan when ``plan`` is a borrowed
    cached template."""
    own = onto if onto is not None else plan
    if sources is None:
        sources = [m for _, m in own.sources]
    if bc_sources is None:
        bc_sources = [m for _, m in own.broadcast_sources]
    if epi_sources is None:
        epi_sources = [m for _, m in own.epilogue_sources]
    if smalls is None:
        smalls = own.small_values()
    if mode not in ("auto", "whole"):
        if mode in ("stream", "ooc"):
            raise NotImplementedError(_STREAM_MODES)
        raise ValueError(f"unknown mode {mode!r}")
    prog = plan.program(lowering.resolve_backend(backend))
    pass_progs = getattr(prog, "passes", None) or [prog]

    carried: dict[int, object] = {}
    finals_all: dict[int, object] = {}
    outs_all: dict[int, object] = {}
    epi_all: dict[int, object] = {}
    pass_bytes: list[int] = []
    src_i = bc_i = epi_i = 0
    for ps, pprog in zip(plan.passes, pass_progs):
        ns, nb, ne = (len(ps.sources), len(ps.broadcast_sources),
                      len(ps.epilogue_sources))
        ps_src = sources[src_i:src_i + ns]
        ps_bc = bc_sources[bc_i:bc_i + nb]
        ps_epi = epi_sources[epi_i:epi_i + ne]
        src_i, bc_i, epi_i = src_i + ns, bc_i + nb, epi_i + ne
        bindings = {nid: carried[nid] for nid in ps.binding_ids}
        for nid, mat in ps.broadcast_source_pairs(ps_bc):
            bindings[nid] = mat.logical_data()
        t_pass = time.perf_counter()
        with TRACER.span("pass", idx=ps.idx, mode="whole",
                         partition_rows=ps.partition_rows):
            finals, outputs, epi_outs = _run_whole_group(
                ps, pprog, ps_src, smalls, ps_epi, bindings)
        metrics.inc("pass_seconds", time.perf_counter() - t_pass)
        pass_bytes.append(ps.bytes_in(ps_src))
        finals_all.update(finals)
        outs_all.update(outputs)
        epi_all.update(epi_outs)
        carried.update(finals)
        carried.update(epi_outs)
    metrics.put("pass_bytes_in", tuple(pass_bytes))
    _store_results(plan, finals_all, outs_all, epi_all, onto=own)
    return plan


def _run_epilogue(ps, prog, sink_finals, epi_sources, smalls, bindings):
    """Invoke the lowered epilogue exactly once after a pass's merge; its
    inputs are device tensors (``epilogue_host_inputs`` counts any that
    are not)."""
    if prog.epilogue is None:
        return {}
    epi_vals = {nid: mat.logical_data()
                for nid, mat in ps.epilogue_source_pairs(epi_sources)}
    leaves = list(sink_finals.values()) + list(epi_vals.values())
    metrics.inc("epilogue_host_inputs", sum(
        1 for leaf in leaves if isinstance(leaf, np.ndarray)))
    metrics.inc("epilogue_launches")
    t0 = time.perf_counter()
    with TRACER.span("epilogue", idx=ps.idx):
        outs = prog.epilogue(sink_finals, epi_vals, smalls, bindings)
        _sync()
    metrics.inc("epilogue_seconds", time.perf_counter() - t0)
    return outs


def _store_results(plan: Plan, sink_finals, outputs, epilogue_outs, *,
                   onto: Plan):
    """Register the execution's values as each result node's cached store,
    on ``onto``'s nodes (positionally aligned with the template's), under
    _DAG_LOCK."""
    with _DAG_LOCK:
        for node, dst in zip(plan.sinks, onto.sinks):
            dst.cached_store = FMMatrix(
                dst.shape, dst.dtype, store=DenseStore(sink_finals[node.id]),
                name=dst.name)
        values = dict(outputs)
        values.update(epilogue_outs)
        tmpl_outs = plan.row_local_roots + plan.saves + plan.epilogue_roots
        own_outs = onto.row_local_roots + onto.saves + onto.epilogue_roots
        for node, dst in zip(tmpl_outs, own_outs):
            dst.cached_store = FMMatrix(
                dst.shape, dst.dtype, store=DenseStore(values[node.id]),
                name=dst.name)
            dst.save = None


# ---------------------------------------------------------------------------
# Eager (unfused) execution — the ablation baseline
# ---------------------------------------------------------------------------

def _materialize_eager(nodes: Sequence[Node], *, mode: str = "auto",
                       backend: Optional[str] = None):
    """Materialize every DAG node separately, each intermediate written out
    in full before the next operation reads it (the ``fuse=False`` arm)."""
    order = Plan._cut_toposort(list(nodes))
    for n in order:
        with _DAG_LOCK:
            if Plan._is_source(n):
                continue
            sub = Plan([wrap(n)])
        _execute_passes(sub, mode=mode, backend=backend)
