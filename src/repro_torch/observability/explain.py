"""Plan explain: a pretty-printer for the fused execution plan (the port's
copy of repro.observability.explain).

``fm.explain(x)`` builds the same `fusion.Plan` that ``fm.materialize(x)``
would execute — cut, pass schedule, both partition tiers, segment IR —
without running it, and renders the planner's decisions:

  * the pass schedule (how many streaming passes, which merged values bind
    forward into later passes);
  * each pass's sources with their storage tier (device/host/disk),
    staging-group deduplication and streamed bytes;
  * each fused segment with its width/dtype/FLOP metadata and both
    partition tiers (I/O-level ``partition_rows``, processor-level
    ``block_rows`` — the paper's §III-F two-level partitioning);
  * the backend dispatch decision per segment: which CUDA kernel matcher
    claimed it, or why it runs the generic torch rules
    (`lowering.dispatch_report`).

The output is stable under node-id renumbering except for the ``#id``
suffixes in node names; golden tests normalize those with ``#\\d+`` → ``#N``.

Imports of ``repro_torch.core`` stay inside the functions: ``core.materialize``
imports ``repro_torch.observability`` at module load, so the package level
here must not import back into core.
"""
from __future__ import annotations


def _tier(mat) -> str:
    if getattr(mat, "on_disk", False):
        return "disk"
    return "host" if getattr(mat, "on_host", False) else "device"


def _mat_label(node, mat) -> str:
    name = getattr(mat, "name", "") or getattr(node, "name", "") or "<anon>"
    return name


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"  # pragma: no cover - loop always returns


def explain(*outputs, backend=None) -> str:
    """Render the fused plan ``fm.materialize(*outputs)`` would run.

    Accepts the same operands as ``fm.materialize`` (FM wrappers or raw
    FMMatrix handles); nothing is computed and no plan-cache entry is
    created.  ``backend`` resolves like materialize's (None/'auto' → the
    engine default).
    """
    from ..core.fusion import Plan

    mats = [getattr(x, "m", x) for x in outputs]
    virtuals = [m for m in mats if getattr(m, "is_virtual", False)]
    if not virtuals:
        return "(nothing to plan: every operand is already materialized)"
    return explain_plan(Plan(virtuals), backend=backend)


def explain_plan(plan, backend=None) -> str:
    """Explain an already-built `fusion.Plan` (``Plan.explain`` delegates
    here)."""
    from ..core import dtypes, lowering

    resolved = lowering.resolve_backend(backend)
    lines = [
        f"Plan: passes={plan.n_passes} long_dim={plan.long_dim} "
        f"backend={resolved}"
        + (f" (resolved from {backend or 'auto'!r})"
           if resolved != backend else ""),
        f"  cost: flops={plan.flop_count():.3e} "
        f"bytes_in={_fmt_bytes(plan.bytes_in())} "
        f"bytes_out={_fmt_bytes(plan.bytes_out())}",
    ]
    for ps in plan.passes:
        lines.append(f"pass {ps.idx}: io_partition_rows={ps.partition_rows}")
        if ps.bindings:
            lines.append("  bindings (from earlier passes): "
                         + ", ".join(n.name for n in ps.bindings))
        for nid, mat in ps.staged_sources():
            group = next(g for g in ps.source_groups if g[0].id == nid)
            alias = (f" (read once for {len(group)} leaves)"
                     if len(group) > 1 else "")
            lines.append(
                f"  source {_mat_label(group[0], mat)}: "
                f"{mat.shape[0]}x{mat.shape[1]} "
                f"{dtypes.name(dtypes.canon(mat.dtype))} tier={_tier(mat)} "
                f"streamed {_fmt_bytes(mat.nbytes())}/pass{alias}")
        for node, mat in ps.broadcast_sources:
            lines.append(f"  broadcast {_mat_label(node, mat)}: "
                         f"{mat.shape[0]}x{mat.shape[1]} tier={_tier(mat)} "
                         f"(staged whole)")
        for node, mat in ps.epilogue_sources:
            lines.append(f"  epilogue-source {_mat_label(node, mat)}: "
                         f"{mat.shape[0]}x{mat.shape[1]} tier={_tier(mat)} "
                         f"(epilogue only)")
        report = lowering.dispatch_report(ps, ps.ir, resolved)
        for seg in ps.ir.segments:
            lines.append("  " + seg.describe())
            lines.append(f"    -> {report.get(seg.sid, '?')}")
    return "\n".join(lines)


def explain_batch(request_groups, backend=None) -> str:
    """Render the co-schedule ``fm.batch`` would run over ``request_groups``
    (a list of requests, each a list of FMMatrix outputs): per round, the
    stream groups with their members, shared physical sources and the
    union bytes the group's one drive reads — against the sum the same
    requests would read serially.  Nothing is computed and no plan-cache
    entry is created."""
    from ..core import dtypes
    from ..core.fusion import Plan, coschedule, stream_group_key

    plans = []
    for outs in request_groups:
        virtuals = [m for m in outs if getattr(m, "is_virtual", False)]
        if virtuals:
            plans.append(Plan(virtuals))
    if not plans:
        return "(nothing to plan: every request is already materialized)"

    n_rounds = max(p.n_passes for p in plans)
    lines = [f"Batch: requests={len(plans)} rounds={n_rounds}"]
    total_union = total_serial = 0.0
    for r in range(n_rounds):
        live = [(i, p) for i, p in enumerate(plans) if r < p.n_passes]
        keys = [stream_group_key(p.passes[r]) for _, p in live]
        lines.append(f"round {r}:")
        for group in coschedule(keys):
            members = [live[g] for g in group]
            union, seen = [], set()
            for _, p in members:
                for _, mat in p.passes[r].staged_sources():
                    if id(mat) not in seen:
                        seen.add(id(mat))
                        union.append(mat)
            union_b = sum(mat.nbytes() for mat in union)
            serial_b = sum(p.passes[r].bytes_in() for _, p in members)
            total_union += union_b
            total_serial += serial_b
            rows = min(p.passes[r].partition_rows for _, p in members)
            lines.append(
                f"  stream group: members={len(members)} "
                f"io_partition_rows={rows} "
                f"reads {_fmt_bytes(union_b)} once"
                + (f" (vs {_fmt_bytes(serial_b)} serially)"
                   if len(members) > 1 else ""))
            for mat in union:
                lines.append(
                    f"    source {getattr(mat, 'name', '') or '<anon>'}: "
                    f"{mat.shape[0]}x{mat.shape[1]} "
                    f"{dtypes.name(dtypes.canon(mat.dtype))} "
                    f"tier={_tier(mat)}")
            for i, p in members:
                sinks = ", ".join(n.name for n in p.passes[r].sinks) or "-"
                lines.append(f"    member request[{i}] pass {r}: "
                             f"sinks [{sinks}]")
    lines.append(f"total streamed: {_fmt_bytes(total_union)} batched vs "
                 f"{_fmt_bytes(total_serial)} serial")
    return "\n".join(lines)
