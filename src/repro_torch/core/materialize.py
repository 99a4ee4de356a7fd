"""Materialization engine (paper §III-F), PyTorch port of
repro.core.materialize.

Executes a fused `fusion.Plan` in one of three modes:

* ``whole``  — the entire long dimension as one partition through each
  pass's lowered step: the kernels stream the rows themselves.  What
  ``mode="auto"`` resolves to for device-resident data.
* ``stream`` — the explicit I/O-level partition loop on the device: each
  power-of-two partition of rows (``core/matrix.py``) runs the pass's step,
  and its sink partials fold into the running accumulators with the
  aggregation VUDFs' ``combine``.
* ``ooc``    — the same loop over sources in host RAM or on disk (an
  ``.fmat`` file behind ``storage.MmapStore`` / ``CsrMmapStore``): each
  partition is read from its tier into host memory and copied to the
  device (``storage.prefetch.stage_block``), and long-dimension outputs
  are written to preallocated host buffers.  ``mode="auto"`` resolves to
  it when any source is on the host or on disk.

A ``save='disk'`` output (``fm.persist(x, tier="disk")`` of a virtual
matrix) streams into a preallocated on-disk matrix a partition at a time
(``MmapStore.write_rows``, write-through), or in one go in ``whole`` mode.

Where ``prefetch`` resolves True (the conf default for a host source of
more than one partition) the partitions are staged by the background
``storage.PartitionPrefetcher`` — pinned host slots and a side CUDA stream
on a card — while the compute thread runs the previous partition's step;
otherwise synchronously on the compute thread (``_inline_partitions``, the
prefetch-off ablation).  Each pass runs its epilogue once after the merge,
and results register only after every pass has run.  The final staged
partition of a streaming pass stays resident for the next pass with the
same partition schedule (``prefetch_reuse_hits``), across materializes
inside an ``iteration_scope``.  The plan cache (LRU, under locks) and the
execution counters are the reference's.

The group runners take a list of members: a materialize runs them with
one, ``fm.batch`` (core/batch.py) with every pass co-scheduled onto one
stream — the union of the members' sources staged once a partition, each
member's step on it in turn.  ``fm.serve`` (core/serve.py) also splices a
late member into a live sweep at a partition boundary (``admit``,
`_join_member`); it rides the rest of the sweep and then re-drives the
prefix it missed (`_catch_up`), staged synchronously on the same compute
stream.  Not in this slice: shards (ROADMAP A13).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes, lowering, matrix as matrix_mod
from .dag import LeafNode, Node, wrap
from .fusion import Plan
from .matrix import DenseStore, FMMatrix
from ..observability import metrics
from ..observability.trace import TRACER

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

#: The counters ``exec_stats()`` exposes (the reference's list; the shard
#: counters stay 0 in this slice).  ``streams`` counts physical sweeps over
#: the sources, ``passes`` each member's logical pass (equal for a solo
#: materialize), ``midstream_admits`` the members spliced into a live sweep;
#: ``prefetch_reuse_hits`` counts staged blocks served from the previous
#: pass's resident final partition.
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
    """Wait for the compute stream: only while tracing, for span timing
    fidelity.  The current stream, not the whole card: a device-wide wait
    would also wait for the prefetcher's side-stream copies of the next
    partitions and so serialize what the trace is there to show."""
    if TRACER.enabled and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def materialize(*mats: FMMatrix, mode: str = "auto", fuse: bool = True,
                mesh=None, donate: bool = True, reuse_plans: bool = True,
                prefetch: Optional[bool] = None,
                backend: Optional[str] = None) -> list[FMMatrix]:
    """fm.materialize: force computation of virtual matrices; one physical
    FMMatrix per argument (physical arguments pass through).  Multiple
    arguments materialize together in one fused pass.

    ``mode`` is 'auto' | 'whole' | 'stream' | 'ooc'.  ``prefetch`` picks
    the partition staging of the streaming modes: None = the conf default
    (``fm.set_conf(prefetch=...)``, on for a host source of more than one
    partition), True = the background prefetcher, False = synchronous
    staging.  ``donate`` is the reference's knob:
    PyTorch has no buffer donation, and a staged partition is dropped as
    soon as every step has consumed it, with either value.  ``backend`` is
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
                               prefetch=prefetch, backend=backend)
        return [_result_of(m) for m in mats]

    with _DAG_LOCK:
        plan = Plan(virtuals)
        exec_plan = _acquire_exec_plan(plan, backend, reuse_plans)

    # A cached plan's nodes belong to the first caller's DAG: execution reads
    # the template's programs and registers results onto THIS call's nodes.
    with TRACER.span("materialize", backend=backend,
                     passes=plan.n_passes, outputs=len(virtuals),
                     cached=exec_plan is not plan):
        _execute(exec_plan, onto=plan, mode=mode,
                 sources=[m for _, m in plan.sources],
                 bc_sources=[m for _, m in plan.broadcast_sources],
                 epi_sources=[m for _, m in plan.epilogue_sources],
                 smalls=plan.small_values(), prefetch=prefetch,
                 backend=backend)
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
# Iteration inspector: cross-materialize partition residency
# ---------------------------------------------------------------------------

_INSPECT = threading.local()


def inspecting() -> bool:
    """True while an ``iteration_scope`` is open on this thread."""
    return getattr(_INSPECT, "depth", 0) > 0


@contextlib.contextmanager
def iteration_scope():
    """fm.inspect_iterations: declare an iterative driver's loop.  Inside
    the scope the final staged partition of every streaming pass stays
    resident across materialize calls, so iteration i+1's first pass reuses
    it instead of re-reading it (``prefetch_reuse_hits``).  On exit the
    resident blocks are dropped."""
    _INSPECT.depth = getattr(_INSPECT, "depth", 0) + 1
    try:
        yield
    finally:
        _INSPECT.depth -= 1
        if _INSPECT.depth == 0:
            _INSPECT.residents = None


def _tls_residents():
    return getattr(_INSPECT, "residents", None) if inspecting() else None


def _set_tls_residents(residents):
    if inspecting():
        _INSPECT.residents = residents


class _Resident:
    """The final staged partition of a streaming pass, kept for a following
    pass with the same partition schedule (rows, long_dim: the same final
    row range).  Blocks are keyed by physical-matrix identity; ``mats``
    holds the matrices so an ``id()`` is not reissued while it lives."""

    __slots__ = ("rows", "long_dim", "blocks", "mats")

    def __init__(self, rows: int, long_dim: int, blocks: dict, mats: list):
        self.rows = rows
        self.long_dim = long_dim
        self.blocks = blocks  # {id(mat): staged device block}
        self.mats = mats

    def matches(self, rows: int, long_dim: int) -> bool:
        return self.rows == rows and self.long_dim == long_dim


def _reuse_from(residents, group_pairs, rows: int, long_dim: int):
    """{group key: resident block} for every source of ``group_pairs``
    whose final partition is resident under the same schedule, or None."""
    out = {}
    for entry in residents or ():
        if not entry.matches(rows, long_dim):
            continue
        for key, mat in group_pairs:
            if key not in out and id(mat) in entry.blocks:
                out[key] = entry.blocks[id(mat)]
    return out or None


# ---------------------------------------------------------------------------
# Group runners: one partition sweep, each member's step per partition
# ---------------------------------------------------------------------------

class _PassExec:
    """Executor state of ONE member pass inside a stream group: its
    program, inputs, running accumulators and long-dimension output
    targets (host buffers, spill stores).  ``out_nodes`` pairs each
    output's template node (whose id keys the step's outputs) with the node
    describing where the result goes; ``scopes`` are the metrics scopes a
    batch member adopts around its compute."""

    __slots__ = ("ps", "prog", "sources", "smalls", "epi_sources",
                 "bindings", "out_nodes", "scopes", "accs", "out_parts",
                 "host_bufs", "disk_stores", "finals", "epi_outs")

    def __init__(self, ps, prog, sources, smalls, epi_sources, bindings, *,
                 out_nodes=None, scopes=()):
        self.ps = ps
        self.prog = prog
        self.sources = sources
        self.smalls = smalls
        self.epi_sources = epi_sources
        self.bindings = bindings
        if out_nodes is None:
            outs = ps.row_local_roots + ps.saves
            out_nodes = list(zip(outs, outs))
        self.out_nodes = out_nodes
        self.scopes = tuple(scopes)
        self.accs = ps.init_accs()
        self.out_parts = {tmpl.id: [] for tmpl, _ in out_nodes}
        self.host_bufs: dict[int, np.ndarray] = {}
        self.disk_stores: dict[int, object] = {}
        self.finals = None
        self.epi_outs = None

    def route_outputs(self, start: int, stop: int, outputs: dict):
        """A partition's long-dimension outputs: written through to their
        spill stores (``save='disk'``), into their host buffers (``ooc``),
        or kept on the device in partition order.  A device partition is
        copied to host RAM first (``.cpu()`` waits for the step that made
        it on the current stream), bf16 as float32, the spill file's
        type."""
        for nid, val in outputs.items():
            if nid in self.disk_stores:
                self.disk_stores[nid].write_rows(start,
                                                 matrix_mod.to_host(val))
            elif nid in self.host_bufs:
                self.host_bufs[nid][start:stop] = matrix_mod.to_host(val)
            else:
                self.out_parts[nid].append(val)


def _member_stack(member: _PassExec):
    """The metrics-scope stack to adopt around this member's compute: the
    executor thread's open scopes plus the member's captured ones; None
    when nothing extra is captured."""
    if not member.scopes:
        return None
    cur = metrics.current_scopes()
    extra = [s for s in member.scopes if s not in set(cur)]
    return tuple(cur) + tuple(extra) if extra else None


def _in_stack(stack):
    return metrics.use_scopes(stack) if stack else contextlib.nullcontext()


def _group_staging(members):
    """One ``(key, mat)`` per distinct physical matrix across the members
    (key = the matrix's identity), and per member the canonical-node-id →
    key map that fans a staged block back out to its step."""
    group_pairs: list[tuple[int, object]] = []
    seen: set[int] = set()
    maps: list[dict[int, int]] = []
    for m in members:
        mp = {}
        for nid, mat in m.ps.staged_sources(m.sources):
            if id(mat) not in seen:
                seen.add(id(mat))
                group_pairs.append((id(mat), mat))
            mp[nid] = id(mat)
        maps.append(mp)
    return group_pairs, maps


def _count_member_scopes(member, ambient, stream_scopes: list):
    """A member's request scopes record its own pass and bytes (what a solo
    run of it would read), where they are not already ambient."""
    own = None
    for sc in member.scopes:
        if sc in ambient:
            continue
        if own is None:
            own = member.ps.bytes_in(member.sources)
        sc.inc("passes", 1)
        sc.inc("bytes_streamed", own)
        if sc not in stream_scopes:
            stream_scopes.append(sc)


def _count_stream(members, union_bytes: int):
    """One physical sweep: one stream, the union bytes read once, one
    logical pass per member."""
    metrics.inc("streams")
    metrics.inc("bytes_streamed", union_bytes)
    metrics.inc("passes", len(members))
    ambient = set(metrics.REGISTRY.scopes())
    stream_scopes: list = []
    for m in members:
        _count_member_scopes(m, ambient, stream_scopes)
    for sc in stream_scopes:
        sc.inc("streams", 1)


def _count_admitted(member):
    """A mid-stream-admitted member's logical pass joins the current sweep:
    root passes + 1, streams unchanged.  The catch-up prefix's bytes are
    counted as `_catch_up` stages them; the member's own request scopes see
    what a solo run would report (one stream, its full plan bytes)."""
    metrics.inc("passes")
    metrics.inc("midstream_admits")
    ambient = set(metrics.REGISTRY.scopes())
    stream_scopes: list = []
    _count_member_scopes(member, ambient, stream_scopes)
    for sc in stream_scopes:
        sc.inc("streams", 1)


def _member_step(member, blocks, key_map, start, stop, *, idx):
    """One member's step + combine over the staged partition."""
    mblocks = {nid: blocks[key] for nid, key in key_map.items()}
    metrics.inc("partition_steps")
    t0 = time.perf_counter()
    with TRACER.span("device_step", rows=stop - start, member=idx):
        partials, outputs = member.prog.step(mblocks, member.smalls,
                                             member.bindings, start)
        _sync()
    metrics.inc("device_step_seconds", time.perf_counter() - t0)
    # The paper's partial merge: the partition's sink partials fold into the
    # member's running accumulators with the aggregation VUDFs' combine.
    t0 = time.perf_counter()
    with TRACER.span("combine", member=idx):
        member.accs = member.prog.combine(member.accs, partials)
        _sync()
    metrics.inc("combine_seconds", time.perf_counter() - t0)
    return outputs


def _finish_members(members, stacks):
    """Finalize + epilogue for every member once the sweep completes."""
    for m, stack in zip(members, stacks):
        with _in_stack(stack):
            m.finals = m.ps.finalize_accs(m.accs)
            m.epi_outs = _run_epilogue(m.ps, m.prog, m.finals,
                                       m.epi_sources, m.smalls, m.bindings)
        for nid, buf in m.host_bufs.items():
            m.out_parts[nid] = [buf]
        for st in m.disk_stores.values():
            st.flush()


def _run_whole_group(members):
    """Whole-mode sweep of a group: the union of the members' sources is
    staged once — a device source is its own tensor, a host source is
    copied whole to the device, and a sparse one is its ELL slab as one
    ``SparseBlock`` (``stage_block``: a host slab's leaves copied, and
    counted as its read; never densified) — then every member's step
    consumes it as one partition (offset 0)."""
    from ..storage.prefetch import stage_block
    group_pairs, maps = _group_staging(members)
    long_dim = members[0].ps.long_dim
    blocks = {key: (stage_block(mat, 0, mat.nrow) if mat.is_sparse
                    else _stage_whole(mat))
              for key, mat in group_pairs}
    _count_stream(members, sum(mat.nbytes() for _, mat in group_pairs))
    stacks = [_member_stack(m) for m in members]
    with TRACER.span("stream", members=len(members), mode="whole"):
        with TRACER.span("partition", start=0, stop=long_dim):
            for i, (m, mp, stack) in enumerate(zip(members, maps, stacks)):
                with _in_stack(stack):
                    outputs = _member_step(m, blocks, mp, 0, long_dim, idx=i)
                for nid, val in outputs.items():
                    m.out_parts[nid].append(val)
    _finish_members(members, stacks)


def _inline_partitions(src_pairs, rows: int, n: int, reuse=None):
    """Synchronous partition staging over rows [0, n) in ``rows``-row
    partitions: each source's block is staged on the compute thread
    (``storage.prefetch.stage_block``).  ``reuse`` maps source keys to the
    previous pass's resident final-partition blocks, served in place of the
    last re-read."""
    from ..storage.prefetch import stage_block
    start = 0
    while start < n:
        stop = min(start + rows, n)
        blocks = {}
        for key, mat in src_pairs:
            if stop >= n and reuse and key in reuse:
                blocks[key] = reuse[key]
                metrics.inc("prefetch_reuse_hits")
            else:
                blocks[key] = stage_block(mat, start, stop)
        yield start, stop, blocks
        start = stop


def _alloc_out_targets(member, to_host: bool):
    """Allocate a member's long-dimension output targets before its first
    partition: a spill file for a ``save='disk'`` flag, a host buffer in
    ``ooc`` mode or for a ``save='host'`` flag — bf16 stored as float32."""
    from .. import storage  # deferred: storage imports core
    for tmpl, spec in member.out_nodes:
        target = spec.save or ("host" if to_host else "device")
        if target == "disk":
            # Write-through spill: the output streams into a preallocated
            # on-disk matrix a partition at a time and never exists whole
            # in RAM — in any pass: scale(X, save='disk') spills pass 2.
            member.disk_stores[tmpl.id] = storage.create_matrix(
                storage.spill_path(spec.name), (spec.nrow, spec.ncol),
                dtypes.np_equiv(spec.dtype))
        elif target == "host":
            member.host_bufs[tmpl.id] = np.empty(
                (spec.nrow, spec.ncol), dtypes.np_equiv(spec.dtype))


def _resolve_prefetch(prefetch, group_pairs, rows: int, n: int) -> bool:
    """The reference's rule: an explicit ``prefetch``, else the conf
    default for a host source of more than one partition."""
    if prefetch is not None:
        return bool(prefetch)
    from ..storage import registry
    return bool(registry.get_conf("prefetch") and n > rows
                and any(mat.on_host for _, mat in group_pairs))


def _join_member(member, members, maps, stacks, joined, group_keys,
                 to_host: bool, start: int):
    """Splice a mid-stream-admitted member into a live sweep at the
    partition boundary ``start``: it consumes every partition from there on
    beside the group, then `_catch_up` re-drives the prefix it missed.  Its
    staged sources must be a subset of the group's (it adds consumers to
    blocks already staged, never new staging), and its long-dimension
    outputs row-addressed (host or disk targets): device outputs
    concatenate in partition order, which a late joiner would scramble."""
    mp = {}
    for nid, mat in member.ps.staged_sources(member.sources):
        if id(mat) not in group_keys:
            raise ValueError(
                "mid-stream admission requires the member's staged sources "
                "to be a subset of the live group's")
        mp[nid] = id(mat)
    if any((spec.save or ("host" if to_host else "device")) == "device"
           for _, spec in member.out_nodes):
        raise ValueError(
            "mid-stream admission cannot take device-resident "
            "long-dimension outputs (order-dependent concatenation)")
    _alloc_out_targets(member, to_host)
    members.append(member)
    maps.append(mp)
    stacks.append(_member_stack(member))
    joined[len(members) - 1] = start
    _count_admitted(member)


def _catch_up(members, maps, stacks, joined, group_pairs, rows: int):
    """Re-drive the partition prefix [0, join start) that the mid-stream
    members missed, after the sweep, staged synchronously
    (``storage.prefetch.stage_block``) for the compute stream the sweep ran
    on.  Sink combines are order-independent and late long-dimension
    outputs row-addressed (`_join_member`), so the prefix after the tail is
    exact — though a float32 sink folds its partials in another order than
    a solo run."""
    from ..storage.prefetch import stage_block
    max_join = max(joined.values())
    late_keys = {key for idx in joined for key in maps[idx].values()}
    pairs = [(key, mat) for key, mat in group_pairs if key in late_keys]
    start = 0
    with TRACER.span("catch_up", members=len(joined), upto=max_join):
        while start < max_join:
            stop = min(start + rows, max_join)
            blocks = {key: stage_block(mat, start, stop)
                      for key, mat in pairs}
            metrics.inc("bytes_streamed",
                        sum(int(b.nbytes) for b in blocks.values()))
            with TRACER.span("partition", start=start, stop=stop):
                for i, j0 in joined.items():
                    if j0 <= start:
                        continue
                    with _in_stack(stacks[i]):
                        outputs = _member_step(members[i], blocks, maps[i],
                                               start, stop, idx=i)
                    members[i].route_outputs(start, stop, outputs)
            del blocks
            start = stop


def _run_stream_group(members, *, to_host: bool,
                      prefetch: Optional[bool] = None, residents=None,
                      capture: bool = False, admit=None,
                      depth: Optional[int] = None):
    """Stream ONE group of member passes partition by partition: one
    staging sweep over the union of the members' sources, every member's
    step consuming each staged partition (1 stream × k steps; a solo
    materialize is the one-member case).

    ``residents`` holds the previous pass's resident final partition(s):
    matching blocks are served instead of re-staged.  With ``capture`` the
    sweep's own final partition is returned as a `_Resident`.  ``admit``
    is the mid-stream admission hook (``fm.serve``): called at every
    partition boundary with ``(start, stop)``, it returns the new members
    that join the sweep from that partition on (`_join_member`); after the
    sweep they catch up on the prefix they missed (`_catch_up`).  ``depth``
    overrides the prefetch depth; None negotiates a group-aware one.  A
    staging error propagates — unchanged from the synchronous path, as a
    ``PrefetchError`` naming the rows and the source from the prefetcher —
    and so does a step error; nothing is registered."""
    from .. import storage  # deferred: storage imports core
    n = members[0].ps.long_dim
    # Partition schedules in one group are power-of-two row counts over the
    # same long dimension: the min is a common partitioning for all members.
    rows = min(m.ps.partition_rows for m in members)
    group_pairs, maps = _group_staging(members)
    _count_stream(members, sum(mat.nbytes() for _, mat in group_pairs))
    for m in members:
        _alloc_out_targets(m, to_host)

    reuse_map = _reuse_from(residents, group_pairs, rows, n)
    group_keys = {key for key, _ in group_pairs}
    joined: dict[int, int] = {}  # member index -> partition start it joined
    stacks = [_member_stack(m) for m in members]
    captured = None
    if _resolve_prefetch(prefetch, group_pairs, rows, n):
        if depth is None:
            # Group-aware depth: k members consume each staged partition,
            # so the stager can usefully run further ahead.
            part_nbytes = rows * sum(mat.nbytes() // max(1, mat.shape[0])
                                     for _, mat in group_pairs)
            depth = storage.negotiate_depth(len(members), part_nbytes)
        # Nothing may come between the pipeline's construction and the try
        # below: the finally's close() is what guarantees an interrupted
        # stream never leaves the worker thread alive or partitions queued.
        parts = storage.PartitionPrefetcher(group_pairs, rows, n,
                                            depth=depth, reuse=reuse_map)
    else:
        parts = _inline_partitions(group_pairs, rows, n, reuse=reuse_map)
    try:
        with TRACER.span("stream", members=len(members), rows=rows,
                         reused=len(reuse_map or ())):
            for start, stop, blocks in parts:
                if admit is not None:
                    for new_member in admit(start, stop):
                        _join_member(new_member, members, maps, stacks,
                                     joined, group_keys, to_host, start)
                with TRACER.span("partition", start=start, stop=stop):
                    for i, (m, mp, stack) in enumerate(zip(members, maps,
                                                           stacks)):
                        with _in_stack(stack):
                            outputs = _member_step(m, blocks, mp, start,
                                                   stop, idx=i)
                        m.route_outputs(start, stop, outputs)
                    if capture and stop >= n:
                        captured = _Resident(
                            rows, n,
                            {key: blocks[key] for key, _ in group_pairs},
                            [mat for _, mat in group_pairs])
                # drop the partition before asking for the next: the
                # prefetcher's staged memory bound counts on it
                del blocks
    finally:
        parts.close()
    if joined:
        _catch_up(members, maps, stacks, joined, group_pairs, rows)
    _finish_members(members, stacks)
    return captured


# ---------------------------------------------------------------------------
# Fused execution
# ---------------------------------------------------------------------------

def _execute(plan: Plan, **kw):
    """`_execute_passes`, clearing the thread's resident partition when an
    execution fails: after a partial run it matches no upcoming schedule,
    and keeping it would hold device memory for the rest of the scope."""
    try:
        return _execute_passes(plan, **kw)
    except BaseException:
        _set_tls_residents(None)
        raise


def _execute_passes(plan: Plan, *, onto: Optional[Plan] = None,
                    mode: str = "auto", sources=None, smalls=None,
                    prefetch: Optional[bool] = None,
                    backend: Optional[str] = None,
                    epi_sources=None, bc_sources=None):
    """Run every pass of ``plan`` in order, carrying each pass's merged
    sinks and epilogue outputs forward as the next pass's bindings, then
    register the results — only after every pass has succeeded, so an
    interrupted pass leaves no partial sinks.  ``onto`` is the caller's own
    equal-signature plan when ``plan`` is a borrowed cached template.

    A streaming pass keeps its final staged partition resident when the
    next pass — of this plan, or inside an ``iteration_scope`` the next
    materialize's first — runs the same partition schedule over a shared
    physical matrix."""
    own = onto if onto is not None else plan
    if sources is None:
        sources = [m for _, m in own.sources]
    if bc_sources is None:
        bc_sources = [m for _, m in own.broadcast_sources]
    if epi_sources is None:
        epi_sources = [m for _, m in own.epilogue_sources]
    if smalls is None:
        smalls = own.small_values()
    mode = _pick_mode_src(sources, mode)
    if mode not in ("whole", "stream", "ooc"):
        raise ValueError(f"unknown mode {mode!r}")
    prog = plan.program(lowering.resolve_backend(backend))
    pass_progs = getattr(prog, "passes", None) or [prog]

    carried: dict[int, object] = {}
    finals_all: dict[int, object] = {}
    parts_all: dict[int, list] = {}
    epi_all: dict[int, object] = {}
    disk_all: dict[int, object] = {}
    pass_bytes: list[int] = []
    residents = _tls_residents()
    src_i = bc_i = epi_i = 0
    for k, (ps, pprog) in enumerate(zip(plan.passes, pass_progs)):
        ns, nb, ne = (len(ps.sources), len(ps.broadcast_sources),
                      len(ps.epilogue_sources))
        ps_src = sources[src_i:src_i + ns]
        ps_bc = bc_sources[bc_i:bc_i + nb]
        ps_epi = epi_sources[epi_i:epi_i + ne]
        src_i, bc_i, epi_i = src_i + ns, bc_i + nb, epi_i + ne
        # Pass bindings: earlier passes' merged values, plus this pass's
        # whole-staged small physical sources.
        bindings = {nid: carried[nid] for nid in ps.binding_ids}
        for nid, mat in ps.broadcast_source_pairs(ps_bc):
            bindings[nid] = _stage_whole(mat)
        out_nodes = None
        if own is not plan:
            own_ps = own.passes[k]
            out_nodes = list(zip(ps.row_local_roots + ps.saves,
                                 own_ps.row_local_roots + own_ps.saves))
        member = _PassExec(ps, pprog, ps_src, smalls, ps_epi, bindings,
                           out_nodes=out_nodes)
        t_pass = time.perf_counter()
        with TRACER.span("pass", idx=ps.idx, mode=mode,
                         partition_rows=ps.partition_rows):
            if mode == "whole":
                _run_whole_group([member])
                residents = None
            else:
                capture = inspecting()
                nxt = plan.passes[k + 1] if k + 1 < len(plan.passes) else None
                if (not capture and nxt is not None
                        and nxt.partition_rows == ps.partition_rows):
                    cur_ids = {id(mat)
                               for _, mat in ps.staged_sources(ps_src)}
                    nxt_src = sources[src_i:src_i + len(nxt.sources)]
                    capture = any(
                        id(mat) in cur_ids
                        for _, mat in nxt.staged_sources(nxt_src))
                entry = _run_stream_group(
                    [member], to_host=(mode == "ooc"), prefetch=prefetch,
                    residents=residents, capture=capture)
                residents = [entry] if entry is not None else None
        metrics.inc("pass_seconds", time.perf_counter() - t_pass)
        pass_bytes.append(ps.bytes_in(ps_src))
        finals_all.update(member.finals)
        parts_all.update(member.out_parts)
        epi_all.update(member.epi_outs)
        disk_all.update(member.disk_stores)
        carried.update(member.finals)
        carried.update(member.epi_outs)
    _set_tls_residents(residents)
    metrics.put("pass_bytes_in", tuple(pass_bytes))
    _store_results(plan, finals_all, parts_all, to_host=(mode == "ooc"),
                   disk_stores=disk_all, epilogue_outs=epi_all, onto=own)
    return plan


def _pick_mode_src(sources, mode: str) -> str:
    if mode != "auto":
        return mode
    if any(mat.on_host for mat in sources):
        return "ooc"
    return "whole"


def _stage_whole(mat):
    """A physical matrix's logical data on the device: a host or disk
    matrix is copied whole, in its canonical dtype (broadcast and epilogue
    sources, pass bindings and whole mode's sources never hand a host
    buffer to a step)."""
    data = mat.logical_data()
    if not isinstance(data, np.ndarray):
        return data
    return matrix_mod.to_device(data)


def _run_epilogue(ps, prog, sink_finals, epi_sources, smalls, bindings):
    """Invoke the lowered epilogue exactly once after a pass's merge; its
    inputs are device tensors (``epilogue_host_inputs`` counts any that
    are not)."""
    if prog.epilogue is None:
        return {}
    epi_vals = {nid: _stage_whole(mat)
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


def _store_results(plan: Plan, sink_finals, out_parts, *, to_host: bool,
                   disk_stores=None, epilogue_outs=None, onto: Plan = None):
    """Register the execution's values as each result node's cached store,
    on ``onto``'s nodes (positionally aligned with the template's), under
    _DAG_LOCK.  Sinks and epilogue results stay on the device in every
    mode; a long-dimension output goes to the host in ``ooc`` mode or
    under a ``save='host'`` flag, and to its spill file under
    ``save='disk'`` (``disk_stores``: written a partition at a time; in
    ``whole`` mode, spilled here in one go)."""
    onto = onto if onto is not None else plan
    with _DAG_LOCK:
        for node, dst in zip(plan.sinks, onto.sinks):
            dst.cached_store = FMMatrix(
                dst.shape, dst.dtype, store=DenseStore(sink_finals[node.id]),
                name=dst.name)
        out_parts = dict(out_parts)
        for node in plan.epilogue_roots:
            out_parts[node.id] = [epilogue_outs[node.id]]
        epi_ids = {n.id for n in plan.epilogue_roots}
        tmpl_outs = plan.row_local_roots + plan.saves + plan.epilogue_roots
        own_outs = onto.row_local_roots + onto.saves + onto.epilogue_roots
        for node, dst in zip(tmpl_outs, own_outs):
            if disk_stores and node.id in disk_stores:
                dst.cached_store = FMMatrix(
                    dst.shape, dst.dtype, store=disk_stores[node.id],
                    name=dst.name)
                dst.save = None
                continue
            parts = out_parts[node.id]
            data = parts[0] if len(parts) == 1 else torch.cat(parts, 0)
            target = dst.save or (
                "host" if to_host and node.id not in epi_ids else None)
            if target == "disk":
                from .. import storage  # deferred: storage imports core
                store = storage.create_matrix(
                    storage.spill_path(dst.name), dst.shape,
                    dtypes.np_equiv(dst.dtype))
                store.write_rows(0, matrix_mod.to_host(data))
                store.flush()
                dst.cached_store = FMMatrix(
                    dst.shape, dst.dtype, store=store, name=dst.name)
                dst.save = None
                continue
            if target == "host" and not isinstance(data, np.ndarray):
                data = matrix_mod.to_host(data)
            dst.cached_store = FMMatrix(
                dst.shape, dst.dtype, store=DenseStore(data), name=dst.name)
            dst.save = None


# ---------------------------------------------------------------------------
# Eager (unfused) execution — the ablation baseline
# ---------------------------------------------------------------------------

def _materialize_eager(nodes: Sequence[Node], *, mode: str = "auto",
                       prefetch: Optional[bool] = None,
                       backend: Optional[str] = None):
    """Materialize every DAG node separately, each intermediate written out
    in full before the next operation reads it (the ``fuse=False`` arm).
    Out of core, every intermediate round-trips the host tier, as an
    unfused engine must."""
    order = Plan._cut_toposort(list(nodes))
    ooc = any(isinstance(n, LeafNode) and n.mat.on_host for n in order)
    for n in order:
        with _DAG_LOCK:
            if Plan._is_source(n):
                continue
            sub = Plan([wrap(n)])
            if ooc and not n.is_sink:
                n.save = "host"
        sub_mode = mode
        if mode == "auto":
            sub_mode = "ooc" if ooc else "whole"
        _execute(sub, mode=sub_mode, prefetch=prefetch, backend=backend)
