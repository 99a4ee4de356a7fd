"""Plan IR: the DAG cut compiled into typed fused segments (PyTorch port of
repro.core.plan_ir, without the sparse tier).

Segments are ``row_local``, ``sink_update``, ``contraction`` and
``epilogue``, each with width/dtype/FLOP metadata and a processor-level
``block_rows`` — computed by the reference's rule, so the schedule key (part
of the plan-cache key) matches.
"""
from __future__ import annotations

import dataclasses
from typing import List

from . import dtypes
from .dag import LeafNode, Node, Small
from .matrix import proc_partition_rows


def _is_source(n: Node) -> bool:
    return isinstance(n, LeafNode) or getattr(n, "cached_store", None) is not None


@dataclasses.dataclass
class Segment:
    """One fused lowering unit of the plan."""

    sid: int
    kind: str   # 'row_local' | 'sink_update' | 'contraction' | 'epilogue'
    nodes: List[Node]         # topological order; nodes[-1] is the root
    root: Node
    width: int                # widest live row (elements) inside the segment
    dtype: object             # widest dtype touched by the segment
    flops_per_row: float
    n_live: int               # live arrays per row while the segment runs
    block_rows: int = 0       # processor-level tile rows

    def describe(self) -> str:
        return (f"seg#{self.sid} [{self.kind}] root={self.root.name} "
                f"nodes={len(self.nodes)} width={self.width} "
                f"dtype={dtypes.name(self.dtype)} "
                f"flops/row={self.flops_per_row:.1f} "
                f"block_rows={self.block_rows}")


@dataclasses.dataclass
class PlanIR:
    """Segments of one DAG cut, in a valid execution order."""

    segments: List[Segment]
    long_dim: int
    consumers: dict = dataclasses.field(default_factory=dict)

    def schedule_key(self) -> tuple:
        return tuple((s.kind, s.block_rows) for s in self.segments)

    def describe(self) -> str:
        lines = [f"PlanIR(long_dim={self.long_dim}, "
                 f"segments={len(self.segments)})"]
        lines += ["  " + s.describe() for s in self.segments]
        return "\n".join(lines)


def compile_ir(plan) -> PlanIR:
    """Group a pass's executable nodes into segments (a row-local node joins
    its consumers' segment when they all live in one) and schedule their
    processor-level tiles."""
    epilogue_ids = getattr(plan, "epilogue_ids", set())
    exec_nodes = [n for n in plan.order
                  if not _is_source(n) and n.id not in epilogue_ids]
    pos = {n.id: i for i, n in enumerate(plan.order)}
    value_roots = {n.id for n in plan.row_local_roots + plan.saves}

    consumers: dict[int, list[Node]] = {n.id: [] for n in exec_nodes}
    for n in exec_nodes:
        seen_parents: set[int] = set()
        for p in n.parents:
            if isinstance(p, Small) or _is_source(p) or p.id in seen_parents:
                continue
            if p.id not in consumers:
                continue  # a pass binding: merged value of an earlier pass
            seen_parents.add(p.id)
            consumers[p.id].append(n)

    seg_of: dict[int, int] = {}
    members: dict[int, list[Node]] = {}
    roots: dict[int, Node] = {}
    kinds: dict[int, str] = {}
    next_sid = 0

    def new_segment(n: Node, kind: str) -> int:
        nonlocal next_sid
        sid = next_sid
        next_sid += 1
        seg_of[n.id] = sid
        members[sid] = [n]
        roots[sid] = n
        kinds[sid] = kind
        return sid

    for n in reversed(exec_nodes):
        if n.is_sink:
            new_segment(n, "contraction" if n.kind == "inner_prod"
                        else "sink_update")
        elif n.id in value_roots:
            new_segment(n, "row_local")
        else:
            owner = {seg_of[c.id] for c in consumers[n.id]}
            if len(owner) == 1:
                sid = owner.pop()
                seg_of[n.id] = sid
                members[sid].append(n)
            else:
                new_segment(n, "row_local")

    segments = []
    for sid in sorted(roots, key=lambda s: pos[roots[s].id]):
        nodes = sorted(members[sid], key=lambda n: pos[n.id])
        segments.append(_with_metadata(
            Segment(sid=len(segments), kind=kinds[sid], nodes=nodes,
                    root=roots[sid], width=1, dtype=roots[sid].dtype,
                    flops_per_row=0.0, n_live=1)))
    epi_nodes = getattr(plan, "epilogue_nodes", [])
    if epi_nodes:
        segments.append(_with_metadata(
            Segment(sid=len(segments), kind="epilogue",
                    nodes=list(epi_nodes), root=epi_nodes[-1], width=1,
                    dtype=epi_nodes[-1].dtype, flops_per_row=0.0,
                    n_live=1)))
    return PlanIR(segments=segments, long_dim=plan.long_dim,
                  consumers=consumers)


def _with_metadata(seg: Segment) -> Segment:
    """Fill width/dtype/flops and schedule the processor-level tile."""
    inside = {n.id for n in seg.nodes}
    widths = [1]
    ext_inputs: set[int] = set()
    widest = seg.root.dtype
    flops = 0.0
    for n in seg.nodes:
        flops += n.flops_per_row()
        if dtypes.rank(n.dtype) > dtypes.rank(widest):
            widest = n.dtype
        if not n.is_sink:
            widths.append(n.ncol)
        for p in n.parents:
            if isinstance(p, Small):
                continue
            if dtypes.rank(p.dtype) > dtypes.rank(widest):
                widest = p.dtype
            widths.append(p.ncol)
            if p.id not in inside:
                ext_inputs.add(p.id)
    seg.width = max(widths)
    seg.dtype = dtypes.canon(widest)
    seg.flops_per_row = flops
    seg.n_live = max(1, len(ext_inputs)) + 1
    seg.block_rows = proc_partition_rows(seg.width, seg.dtype, seg.n_live)
    return seg
