"""Fusion optimizer: a DAG cut → a schedule of partition-streaming passes
(PyTorch port of repro.core.fusion).

`Plan` cuts the DAG at persisted nodes, toposorts the induced subgraph and
schedules it as an ordered list of passes (`PassSchedule`).  Most programs
are one pass; a merged value feeding a row-local op (``scale(X)``) schedules
as moment pass → sweep pass, all under one plan-cache entry and one
``fm.materialize`` call.  The schedule, the epilogue roles, the staging
groups, the partition sizes and the signature are the reference's.  Under a
configured mesh (``fm.set_conf(mesh=...)``) each pass also carries its
per-shard row ranges (``shard_ranges``), part of the plan-cache key.
"""
from __future__ import annotations

import threading
from typing import Sequence

import torch

from . import dtypes, plan_ir
from .dag import (LeafNode, Node, SinkNode, Small, as_node, long_dim_of,
                  schedule_passes)
from .matrix import FMMatrix, io_partition_rows
from .sparse import effective_ncol


def shard_ranges(long_dim: int, partition_rows: int,
                 n_shards: int) -> list[tuple[int, int]]:
    """Contiguous, partition-aligned half-open row ranges splitting
    ``[0, long_dim)`` into ``n_shards`` shards.

    Every boundary lands on a multiple of ``partition_rows``, so each shard
    streams whole I/O-level partitions, and partitions are spread as evenly
    as possible (leading shards take the remainder).  With fewer
    partitions than shards the trailing ranges are empty ``(start,
    start)``: those shards idle."""
    n_shards = max(1, int(n_shards))
    n_parts = max(1, -(-int(long_dim) // max(1, int(partition_rows))))
    base, extra = divmod(n_parts, n_shards)
    ranges, part = [], 0
    for s in range(n_shards):
        take = base + (1 if s < extra else 0)
        lo = min(part * partition_rows, long_dim)
        part += take
        hi = min(part * partition_rows, long_dim)
        ranges.append((int(lo), int(hi)))
    return ranges


def _conf_data_shards() -> int:
    """Data-axis size of the configured mesh (``fm.set_conf(mesh=...)``),
    1 when unsharded.  Deferred imports: storage imports core."""
    from ..storage import registry
    mesh = registry.get_conf("mesh")
    if mesh is None:
        return 1
    from ..distributed.sharding import data_axis_size
    return data_axis_size(mesh)


class PassSchedule:
    """One streaming pass of a plan: its cut classification, staging groups,
    partition size and segment IR (see repro.core.fusion.PassSchedule).

    Physical sources split three ways: ``sources`` (long-aligned, streamed),
    ``broadcast_sources`` (small physicals consumed by row-local ops) and
    ``epilogue_sources`` (consumed only by epilogue math).  ``bindings`` are
    merged values of earlier passes that this pass consumes."""

    def __init__(self, plan: "Plan", idx: int):
        self.idx = idx
        self.long_dim = plan.long_dim
        self.smalls = plan.smalls
        self._small_pos = plan._small_pos
        roles, passno = plan.roles, plan.passno
        is_src = plan._is_source

        execu = [n for n in plan.order
                 if not is_src(n) and passno[n.id] == idx]
        self.epilogue_nodes: list[Node] = [
            n for n in execu if roles[n.id] == "epi"]
        self.epilogue_ids: set[int] = {n.id for n in self.epilogue_nodes}
        self.sinks: list[SinkNode] = [
            n for n in execu if roles[n.id] == "loop" and n.is_sink]
        self.row_local_roots: list[Node] = [
            n for n in plan.requested
            if not is_src(n) and not n.is_sink
            and roles[n.id] == "loop" and passno[n.id] == idx]
        self.saves: list[Node] = [
            n for n in execu
            if n.save is not None and roles[n.id] == "loop"
            and not n.is_sink and n not in self.row_local_roots]
        seen_roots: set[int] = set()
        self.epilogue_roots: list[Node] = []
        for n in list(plan.requested) + [m for m in plan.order
                                         if m.save is not None]:
            if (not is_src(n) and n.id in self.epilogue_ids
                    and n.id not in seen_roots):
                seen_roots.add(n.id)
                self.epilogue_roots.append(n)
        # Unrequested epilogue values a later pass consumes; filled by Plan.
        self.epilogue_carries: list[Node] = []

        # Loop nodes this pass evaluates: the backward closure of its roots
        # through streaming (row-local, non-sink) parents.
        needed: dict[int, Node] = {}

        def pull(n: Node):
            if n.id in needed:
                return
            needed[n.id] = n
            for p in n.parents:
                if isinstance(p, Small) or not isinstance(p, Node) \
                        or is_src(p):
                    continue
                if roles[p.id] == "loop" and not p.is_sink:
                    pull(p)

        for n in self.sinks + self.row_local_roots + self.saves:
            pull(n)
        evaluated = set(needed) | self.epilogue_ids

        consumers: dict[int, list[Node]] = {}
        for n in plan.order:
            if n.id not in evaluated:
                continue
            for p in n.parents:
                if isinstance(p, Node) and is_src(p):
                    consumers.setdefault(p.id, []).append(n)
        self.order: list[Node] = [
            n for n in plan.order
            if n.id in evaluated or (is_src(n) and n.id in consumers)]

        self.bindings: list[Node] = []
        bind_seen: set[int] = set()
        for n in self.order:
            if is_src(n) or n.id not in evaluated:
                continue
            for p in n.parents:
                if (isinstance(p, Small) or not isinstance(p, Node)
                        or is_src(p) or p.id in evaluated
                        or p.id in bind_seen):
                    continue
                bind_seen.add(p.id)
                self.bindings.append(p)
        self.binding_ids: set[int] = bind_seen

        self.sources: list[tuple[Node, FMMatrix]] = []
        self.broadcast_sources: list[tuple[Node, FMMatrix]] = []
        self.epilogue_sources: list[tuple[Node, FMMatrix]] = []
        for n in self.order:
            if isinstance(n, LeafNode):
                mat = n.mat
            elif getattr(n, "cached_store", None) is not None:
                mat = n.cached_store
            else:
                continue
            cons = consumers.get(n.id, [])
            long_aligned = (mat.shape[0] == self.long_dim
                            and max(mat.shape) > 1)
            if cons and all(c.id in self.epilogue_ids for c in cons):
                self.epilogue_sources.append((n, mat))
            elif long_aligned:
                if any(c.id in self.epilogue_ids for c in cons):
                    raise ValueError(
                        f"source {n.name} is consumed by both the partition "
                        f"loop and the plan epilogue; materialize the "
                        f"epilogue expression separately")
                self.sources.append((n, mat))
            else:
                for c in cons:
                    if c.id in self.epilogue_ids:
                        continue
                    if c.is_sink or c.nrow != self.long_dim:
                        raise ValueError(
                            f"source {n.name} shape {mat.shape} rows are "
                            f"not aligned with the streaming dimension "
                            f"{self.long_dim}")
                self.broadcast_sources.append((n, mat))

        # Staging groups: leaves over one physical matrix stage once.
        self.source_groups: list[list[Node]] = []
        self.source_aliases: dict[int, int] = {}
        by_mat: dict[int, int] = {}
        for node, mat in self.sources:
            gi = by_mat.get(id(mat))
            if gi is None:
                by_mat[id(mat)] = len(self.source_groups)
                self.source_groups.append([node])
            else:
                self.source_groups[gi].append(node)
        for group in self.source_groups:
            for node in group:
                self.source_aliases[node.id] = group[0].id

        n_live = max(1, len(self.sources) + len(self.row_local_roots)
                     + len(self.saves))
        widths = [1]
        for node, mat in self.sources:
            # A sparse source budgets at what it streams (2·kmax scalars a
            # row), not its logical ncol.
            widths.append(effective_ncol(mat))
        for n in self.order:
            if (not is_src(n) and not n.is_sink
                    and n.id not in self.epilogue_ids):
                widths.append(n.ncol)
        widest_dtype = max((n.dtype for n in self.order), key=dtypes.rank,
                           default=torch.float32)
        self.partition_rows = io_partition_rows(
            max(widths), widest_dtype, n_live)
        # Per-shard row ranges over the configured mesh's data axis: part of
        # ``Plan.pass_key``, so a mesh change (or a long dimension of fewer
        # partitions than shards) re-plans.
        self.shard_ranges = shard_ranges(
            self.long_dim, self.partition_rows, _conf_data_shards())

        self.ir = plan_ir.compile_ir(self)

    def staged_sources(self, sources=None) -> list[tuple[int, FMMatrix]]:
        """One ``(canonical_node_id, matrix)`` pair per staging group;
        ``sources`` may override the matrices positionally."""
        if sources is None:
            sources = [m for _, m in self.sources]
        id_to_mat = {node.id: mat
                     for (node, _), mat in zip(self.sources, sources)}
        return [(group[0].id, id_to_mat[group[0].id])
                for group in self.source_groups]

    def broadcast_source_pairs(self, mats=None) -> list[tuple[int, FMMatrix]]:
        if mats is None:
            mats = [m for _, m in self.broadcast_sources]
        return [(node.id, mat)
                for (node, _), mat in zip(self.broadcast_sources, mats)]

    def epilogue_source_pairs(self, mats=None) -> list[tuple[int, FMMatrix]]:
        if mats is None:
            mats = [m for _, m in self.epilogue_sources]
        return [(node.id, mat)
                for (node, _), mat in zip(self.epilogue_sources, mats)]

    def init_accs(self):
        return {n.id: n.identity() for n in self.sinks}

    def finalize_accs(self, accs):
        return {n.id: n.finalize(accs[n.id]) for n in self.sinks}

    def bytes_in(self, sources=None) -> int:
        return int(sum(mat.nbytes()
                       for _, mat in self.staged_sources(sources)))

    def describe(self) -> str:
        lines = [f"pass {self.idx}: partition_rows={self.partition_rows} "
                 f"bindings={[n.name for n in self.bindings]}"]
        for n in self.order:
            role = ("source" if isinstance(n, LeafNode)
                    or getattr(n, "cached_store", None) is not None
                    else "epilog" if n.id in self.epilogue_ids
                    else "sink" if n.is_sink else "fused")
            lines.append(f"  [{role:6s}] {n!r}")
        lines.extend("  " + line for line in self.ir.describe().splitlines())
        return "\n".join(lines)


class Plan:
    """A fused execution plan over one DAG cut: an ordered pass schedule."""

    def __init__(self, outputs: Sequence[FMMatrix], *, fuse: bool = True):
        self.requested = [as_node(o) for o in outputs]
        self.fuse = fuse

        self.order = self._cut_toposort(list(self.requested))
        self.long_dim = long_dim_of(self.order)
        self.roles, self.passno = schedule_passes(
            self.order, is_source=self._is_source, long_dim=self.long_dim)
        self.n_passes = 1 + max(self.passno.values(), default=0)

        # Small operands are runtime arguments of the lowered steps, so a
        # structurally identical plan (k-means iteration N+1) reuses the
        # cached program.
        self.smalls: list[Small] = []
        self._small_pos: dict[int, int] = {}
        for n in self.order:
            if self._is_source(n):
                continue
            for p in n.parents:
                if isinstance(p, Small) and id(p) not in self._small_pos:
                    self._small_pos[id(p)] = len(self.smalls)
                    self.smalls.append(p)

        self.passes: list[PassSchedule] = [
            PassSchedule(self, k) for k in range(self.n_passes)]

        for k, ps in enumerate(self.passes):
            later: set[int] = set()
            for nxt in self.passes[k + 1:]:
                later |= nxt.binding_ids
            roots = {n.id for n in ps.epilogue_roots}
            ps.epilogue_carries = [n for n in ps.epilogue_nodes
                                   if n.id in later and n.id not in roots]

        self.sinks = [n for ps in self.passes for n in ps.sinks]
        self.row_local_roots = [n for ps in self.passes
                                for n in ps.row_local_roots]
        self.saves = [n for ps in self.passes for n in ps.saves]
        self.epilogue_nodes = [n for ps in self.passes
                               for n in ps.epilogue_nodes]
        self.epilogue_ids = set().union(
            *[ps.epilogue_ids for ps in self.passes]) \
            if self.passes else set()
        self.epilogue_roots = [n for ps in self.passes
                               for n in ps.epilogue_roots]
        self.sources = [sm for ps in self.passes for sm in ps.sources]
        self.broadcast_sources = [sm for ps in self.passes
                                  for sm in ps.broadcast_sources]
        self.epilogue_sources = [sm for ps in self.passes
                                 for sm in ps.epilogue_sources]
        self.source_groups = [g for ps in self.passes
                              for g in ps.source_groups]
        self.source_aliases = {}
        for ps in self.passes:
            self.source_aliases.update(ps.source_aliases)

        self.partition_rows = self.passes[0].partition_rows
        self.ir = self.passes[0].ir
        self._programs: dict[str, object] = {}
        self._prog_lock = threading.Lock()

    def program(self, backend: str):
        """The lowered executable for ``backend``: a `LoweredProgram` for a
        one-pass plan, a `MultiPassProgram` otherwise.  Thread-safe."""
        prog = self._programs.get(backend)
        if prog is None:
            with self._prog_lock:
                prog = self._programs.get(backend)
                if prog is None:
                    from . import lowering
                    compiled = [lowering.lower(ps, ps.ir, backend)
                                for ps in self.passes]
                    prog = (compiled[0] if len(compiled) == 1
                            else lowering.MultiPassProgram(compiled))
                    self._programs[backend] = prog
        return prog

    def pass_key(self) -> tuple:
        """Both partition levels of every pass and its per-shard row ranges:
        the non-structural half of the plan-cache key."""
        return tuple((ps.partition_rows, tuple(ps.shard_ranges),
                      ps.ir.schedule_key())
                     for ps in self.passes)

    def signature(self) -> str:
        """Structural identity: two cuts with the same signature share one
        lowered plan (see repro.core.fusion.Plan.signature)."""
        parts = [f"L{self.long_dim}", f"P{self.n_passes}"]
        pos = {n.id: i for i, n in enumerate(self.order)}
        req_pos: dict[int, int] = {}
        for i, n in enumerate(self.requested):
            req_pos.setdefault(n.id, i)
        src_tag: dict[int, list[str]] = {}
        for k, ps in enumerate(self.passes):
            for gi, group in enumerate(ps.source_groups):
                for node in group:
                    src_tag.setdefault(node.id, []).append(f"s{k}.{gi}")
            for node, _ in ps.broadcast_sources:
                src_tag.setdefault(node.id, []).append(f"b{k}")
            for node, _ in ps.epilogue_sources:
                src_tag.setdefault(node.id, []).append(f"E{k}")
        for n in self.order:
            ps_ = []
            parents = [] if self._is_source(n) else n.parents
            for p in parents:
                if isinstance(p, Small):
                    v = p.value
                    shape = tuple(getattr(v, "shape", ()))
                    dt = getattr(v, "dtype", type(v).__name__)
                    ps_.append(f"S{shape}:{dt}")
                else:
                    ps_.append(f"N{pos[p.id]}")
            fn_info = getattr(n, "fn_info", None)
            fname = ""
            if fn_info:
                for key in ("vudf", "mul", "add"):
                    if key in fn_info:
                        fname += f":{fn_info[key].name}"
                if "num_groups" in fn_info:
                    fname += f":g{fn_info['num_groups']}"
            extra = ""
            for attr in ("agg", "mul", "add"):
                v = getattr(n, attr, None)
                if v is not None:
                    extra += f":{v.name}"
            ng = getattr(n, "num_groups", "")
            if self._is_source(n):
                role = "q" + "+".join(src_tag.get(n.id, []))
                mat = n.mat if isinstance(n, LeafNode) \
                    else getattr(n, "cached_store", None)
                store = getattr(mat, "store", None)
                if getattr(store, "sparse", False):
                    # A sparse source stages an ELL block whose width is
                    # kmax: a dense cut of the same shapes must not share
                    # the lowered program.
                    role += f"~csr:{store.max_row_nnz}"
            elif self.roles[n.id] == "epi":
                role = f"e{self.passno[n.id]}"
            elif n.is_sink:
                role = f"s{self.passno[n.id]}"
            else:
                role = f"m{self.passno[n.id]}"
            sv = n.save or ""
            rq = f"r{req_pos[n.id]}" if n.id in req_pos else ""
            parts.append(f"{role}|{n.kind}|{n.shape}|{dtypes.name(n.dtype)}"
                         f"|{fname}|{extra}|{ng}|{sv}|{rq}|{','.join(ps_)}")
        return ";".join(parts)

    def staged_sources(self) -> list[tuple[int, FMMatrix]]:
        """One pair per distinct physical matrix across every pass: the
        denominator of ``passes_over_sources`` (``bytes_in`` counts each
        pass's read, so a two-pass plan over one matrix reports 2.0)."""
        seen: set[int] = set()
        out = []
        for ps in self.passes:
            for nid, mat in ps.staged_sources():
                if id(mat) not in seen:
                    seen.add(id(mat))
                    out.append((nid, mat))
        return out

    def result_nodes(self):
        """Deterministic result slots (sinks + requested + saves +
        epilogue outputs, in pass order)."""
        return (list(self.sinks) + self.row_local_roots + self.saves
                + self.epilogue_roots)

    def small_values(self):
        return [s.value for s in self.smalls]

    @staticmethod
    def _is_source(n: Node) -> bool:
        return isinstance(n, LeafNode) or getattr(n, "cached_store", None) is not None

    @classmethod
    def _cut_toposort(cls, roots):
        """toposort that cuts at nodes previously persisted."""
        seen, order = {}, []

        def visit(n: Node):
            if n.id in seen:
                return
            seen[n.id] = n
            if not cls._is_source(n) or isinstance(n, LeafNode):
                if getattr(n, "cached_store", None) is None:
                    for p in n.parent_nodes():
                        visit(p)
            order.append(n)

        for r in roots:
            visit(r)
        return order

    def flop_count(self) -> float:
        total = 0.0
        for ps in self.passes:
            for n in ps.order:
                if (not self._is_source(n)
                        and n.id not in ps.epilogue_ids):
                    total += n.flops_per_row() * self.long_dim
        return float(total)

    def bytes_in(self) -> int:
        return int(sum(ps.bytes_in() for ps in self.passes))

    def bytes_out(self) -> int:
        total = 0
        for n in (self.row_local_roots + self.saves + list(self.sinks)
                  + self.epilogue_roots):
            total += n.nrow * n.ncol * dtypes.nbytes(n.dtype)
        return int(total)

    def explain(self, backend: str | None = None) -> str:
        """The planner's decisions for humans (``fm.explain``): the pass
        schedule, each source's tier and streamed bytes, both partition
        levels and the per-segment backend dispatch
        (observability/explain.py)."""
        from ..observability.explain import explain_plan
        return explain_plan(self, backend=backend)

    def describe(self) -> str:
        lines = [f"Plan(long_dim={self.long_dim}, passes={self.n_passes},"
                 f" fuse={self.fuse})"]
        for ps in self.passes:
            lines.extend("  " + line for line in ps.describe().splitlines())
        lines.append(f"  flops={self.flop_count():.3e} bytes_in={self.bytes_in():.3e}"
                     f" bytes_out={self.bytes_out():.3e}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-plan co-scheduling (the batch layer, core/batch.py)
# ---------------------------------------------------------------------------

def stream_group_key(ps: PassSchedule, sources=None) -> tuple:
    """The co-schedule signature of one pass: its long dimension plus the
    identity set of the physical matrices it streams.  Two passes with
    compatible keys (equal, or one source set a subset of the other, same
    long dimension) can share one streaming drive.  Partition row counts
    need not match: they are powers of two under one I/O budget, so the
    group runs at the smallest member's rows."""
    return (ps.long_dim,
            frozenset(id(m) for _, m in ps.staged_sources(sources)))


def coschedule(keys) -> list[list[int]]:
    """Group member passes (given their `stream_group_key`s) onto shared
    streaming drives: groups of member indices, input order kept inside
    each group.  Equal keys share a drive; a member whose source set is a
    strict subset of an existing group's rides that group's stream.  A pass
    that streams nothing gets a group of its own.  Supersets are seeded
    first, so a subset always finds its carrier."""
    keys = list(keys)
    order = sorted(range(len(keys)), key=lambda i: -len(keys[i][1]))
    groups: list[list[int]] = []
    group_keys: list[tuple] = []
    for i in order:
        long_dim, mats = keys[i]
        placed = False
        if mats:
            for gi, (g_long, g_mats) in enumerate(group_keys):
                if g_long == long_dim and mats <= g_mats:
                    groups[gi].append(i)
                    placed = True
                    break
        if not placed:
            groups.append([i])
            group_keys.append((long_dim, mats))
    for g in groups:
        g.sort()
    return groups
