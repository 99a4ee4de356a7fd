"""Pluggable lowering backends: plan IR → executable partition programs
(PyTorch port of repro.core.lowering).

    partials, row_local_outputs = program.step(source_blocks, smalls, bindings, offset)
    accs = program.combine(accs, partials)

Backends:

* ``torch`` — the twin of the reference's ``xla``: every segment runs node by
  node through the generic ``block_eval`` / ``block_update`` rules.
* ``cuda``  — the twin of ``pallas``: the same matchers claim segments for
  the hand-written Hopper kernels in `repro_torch/kernels/` — contractions
  over a sparse (ELL) source → ``spmm_gram`` / ``spmm_xty`` /
  ``spmm_wgram`` (matched first, so a dense kernel never sees an ELL
  block), the Lloyd pattern → ``kmeans_assign``, ``crossprod(X * w, X)`` →
  ``wgram``, ``crossprod(X)`` → ``gram``, ``crossprod(X, Y)`` → ``xty``,
  apply→agg.col chains over one source → ``fused_apply_agg``.  Unclaimed
  segments run the generic rules.  A kernel wrapper handed a CUDA tensor
  launches its kernel or raises; it takes its plain PyTorch version only for
  a tensor on the CPU, so the CPU tests drive the real matchers and units.

``'auto'`` resolves to ``cuda`` when the engine's device is a CUDA device
and to ``torch`` on the CPU.  PyTorch runs eagerly: there is no counterpart
of the reference's ``jax.jit`` and buffer donation, so the step frees each
full-height value itself after the last unit that reads it
(``LoweredProgram.release``) — XLA frees them in the reference.
"""
from __future__ import annotations

import torch

from . import dtypes
from .dag import (AggFullNode, GroupByRowNode, InnerProdContractNode,
                  MapNode, Node, Small)
from .sparse import SparseBlock, is_sparse_mat

# ---------------------------------------------------------------------------
# Backend registry + selection
# ---------------------------------------------------------------------------

BACKENDS: dict[str, "Backend"] = {}

#: Engine-wide default, settable via fm.set_conf(backend=...).
DEFAULT_BACKEND = "auto"


def register_backend(name: str, backend: "Backend"):
    BACKENDS[name] = backend
    return backend


def resolve_backend(name: str | None = None) -> str:
    """'auto' (or None) → cuda on a CUDA device, torch on the CPU."""
    name = name or DEFAULT_BACKEND
    if name == "auto":
        from ..storage import registry  # deferred: storage imports core
        return "cuda" if registry.device().type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; have {sorted(BACKENDS)} + 'auto'")
    return name


def lower(plan, ir, backend: str) -> "LoweredProgram":
    return BACKENDS[backend].lower(plan, ir)


# ---------------------------------------------------------------------------
# The lowered program
# ---------------------------------------------------------------------------

class LoweredProgram:
    """An executable lowering of ONE PASS of a plan: per-partition ``step``,
    the sink-partial ``combine`` merge, and — when the pass has post-sink
    lazy math — an ``epilogue`` the executor invokes exactly once after the
    merge: ``epilogue(merged_sinks, epilogue_sources, smalls, bindings)``.

    ``release`` is the step's liveness rule: after each generic node (key
    ``("node", id)``) or kernel unit (key ``("unit", index)``), the values
    that nothing later in the pass reads and that are not outputs of the
    pass.  In whole mode a value is full height (GMM at 65.6M rows makes
    three 8.4 GB temporaries per component); keeping them all to the end of
    the pass would need hundreds of GB."""

    def __init__(self, plan, ir, backend: str, units):
        self.plan = plan
        self.ir = ir
        self.backend = backend
        self.units = units
        self._sinks_by_id = {n.id: n for n in plan.sinks}
        self.epilogue = self._epilogue if plan.epilogue_nodes else None
        self.release = _release_plan(
            units, {n.id for n in plan.row_local_roots + plan.saves})

    @property
    def kernel_units(self):
        """The units lowered onto hand-written kernels (empty under torch)."""
        return [u for u in self.units if getattr(u, "kernel", None)]

    def describe(self) -> str:
        lines = [f"LoweredProgram(backend={self.backend}, "
                 f"units={len(self.units)})"]
        lines += ["  " + u.describe() for u in self.units]
        if self.epilogue is not None:
            lines.append(f"  epilogue nodes={len(self.plan.epilogue_nodes)} "
                         f"outs={[n.name for n in self.plan.epilogue_roots]}")
        return "\n".join(lines)

    def step(self, source_blocks, smalls, bindings, offset):
        """One I/O-level partition through the fused cut of this pass;
        returns (sink_partials, row_local_outputs).  ``source_blocks`` holds
        one block per staging group (keyed by its canonical node id)."""
        values = {nid: source_blocks[canon]
                  for nid, canon in self.plan.source_aliases.items()}
        values.update(bindings)
        partials = {n.id: n.identity() for n in self.plan.sinks}
        for i, unit in enumerate(self.units):
            if unit.kernel is None:
                unit.run(values, partials, smalls, offset, self.release)
                continue
            unit.run(values, partials, smalls, offset)
            for vid in self.release.get(("unit", i), ()):
                values.pop(vid, None)
        outputs = {n.id: values[n.id]
                   for n in self.plan.row_local_roots + self.plan.saves}
        return partials, outputs

    def combine(self, accs, partials):
        return {nid: self._sinks_by_id[nid].combine(accs[nid], partials[nid])
                for nid in accs}

    def _epilogue(self, sink_finals, epi_sources, smalls, bindings):
        """The pass's post-sink lazy math on the finalized sink values;
        returns its roots plus the carries a later pass consumes."""
        values = dict(bindings)
        values.update(epi_sources)
        values.update(sink_finals)
        for n in self.plan.epilogue_nodes:
            blocks = [smalls[self.plan._small_pos[id(p)]]
                      if isinstance(p, Small) else values[p.id]
                      for p in n.parents]
            if n.is_sink:
                acc = n.block_update(n.identity(), blocks, 0)
                values[n.id] = n.finalize(acc)
            else:
                values[n.id] = n.block_eval(blocks, 0)
        outs = {n.id: values[n.id] for n in self.plan.epilogue_roots}
        for n in getattr(self.plan, "epilogue_carries", []):
            outs[n.id] = values[n.id]
        return outs


class MultiPassProgram:
    """One `LoweredProgram` per pass, run in order under one plan-cache
    entry; pass k+1's bindings come from pass k's merged values."""

    def __init__(self, passes):
        self.passes = list(passes)
        self.backend = self.passes[0].backend if self.passes else "?"

    @property
    def kernel_units(self):
        return [u for p in self.passes for u in p.kernel_units]

    @property
    def epilogue(self):
        return next((p.epilogue for p in self.passes
                     if p.epilogue is not None), None)

    def describe(self) -> str:
        lines = [f"MultiPassProgram(passes={len(self.passes)})"]
        for k, p in enumerate(self.passes):
            lines.append(f" pass {k}:")
            lines.extend("  " + line for line in p.describe().splitlines())
        return "\n".join(lines)


def _release_plan(units, keep: set) -> dict:
    """{step key: value ids to drop after that step}: each value goes after
    its last reader (a generic node, or a kernel unit as a whole); a generic
    node's value that nothing reads goes right after it is made.  Values in
    ``keep`` (the pass's outputs) stay."""
    last: dict[int, tuple] = {}
    made: list[tuple] = []
    for i, unit in enumerate(units):
        if unit.kernel is None:
            for n in unit.nodes:
                for p in n.parents:
                    if not isinstance(p, Small):
                        last[p.id] = ("node", n.id)
                if not n.is_sink:
                    made.append((n.id, ("node", n.id)))
        else:
            for vid in unit.reads():
                last[vid] = ("unit", i)
    for vid, key in made:
        last.setdefault(vid, key)
    release: dict[tuple, list] = {}
    for vid, key in last.items():
        if vid not in keep:
            release.setdefault(key, []).append(vid)
    return release


class GroupProgram:
    """The co-scheduled executable of one stream group (core/batch.py): k
    member passes driven over a single shared partition stream.

    The members keep their own lowered ``step``/``combine``/``epilogue``;
    what the group composes is the schedule — while a staged partition is
    resident, every member's step consumes it before it is dropped, so k
    plans × 1 stream executes as 1 stream × k steps.  ``members`` holds
    ``(PassSchedule, LoweredProgram)`` pairs in execution order; the
    runner is ``materialize._run_stream_group``."""

    def __init__(self, members):
        self.members = list(members)

    @property
    def kernel_units(self):
        return [u for _, prog in self.members for u in prog.kernel_units]

    @property
    def partition_rows(self) -> int:
        """The group's common partitioning: the smallest member's rows (all
        are powers of two under one I/O budget, so every member's schedule
        divides it)."""
        return min(ps.partition_rows for ps, _ in self.members)

    def describe(self) -> str:
        lines = [f"GroupProgram(members={len(self.members)}, "
                 f"partition_rows={self.partition_rows})"]
        for i, (ps, prog) in enumerate(self.members):
            lines.append(f" member {i} (pass {ps.idx}, "
                         f"rows={ps.partition_rows}):")
            lines.extend("  " + line
                         for line in prog.describe().splitlines())
        return "\n".join(lines)


class Backend:
    name = "?"

    def lower(self, plan, ir) -> LoweredProgram:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Execution units
# ---------------------------------------------------------------------------

class GenericUnit:
    """Run a segment node by node through the dag eval rules (the torch
    path, and the fallback for segments no kernel matcher claims)."""

    kernel = None

    def __init__(self, plan, segment):
        self.plan = plan
        self.segment = segment
        self.nodes = segment.nodes

    def describe(self) -> str:
        return (f"generic seg#{self.segment.sid} [{self.segment.kind}] "
                f"root={self.segment.root.name}")

    def run(self, values, partials, smalls, offset, release=None):
        # A sparse (ELL) block densifies into a LOCAL cache: only node rules
        # with no sparse path see the dense form, and the shared ``values``
        # keeps the SparseBlock for a kernel unit reading the same leaf.
        # matmul_small keeps its gather path (dag._inner_prod_block takes a
        # SparseBlock left operand).
        dense: dict[int, object] = {}

        def block_of(n, pos, p):
            v = values[p.id]
            if isinstance(v, SparseBlock) and not (
                    n.kind == "matmul_small" and pos == 0):
                if p.id not in dense:
                    dense[p.id] = v.todense()
                v = dense[p.id]
            return v

        for n in self.nodes:
            blocks = [smalls[self.plan._small_pos[id(p)]]
                      if isinstance(p, Small) else block_of(n, i, p)
                      for i, p in enumerate(n.parents)]
            if n.is_sink:
                partials[n.id] = n.block_update(partials[n.id], blocks, offset)
            else:
                values[n.id] = n.block_eval(blocks, offset)
            del blocks
            for vid in (release or {}).get(("node", n.id), ()):
                values.pop(vid, None)
                dense.pop(vid, None)


class _KernelUnit:
    """Base for units lowered onto a hand-written kernel."""

    def __init__(self, kernel: str):
        self.kernel = kernel

    def describe(self) -> str:
        return f"cuda:{self.kernel} root={self.node.name}"

    @staticmethod
    def _merge(partials, node, part):
        partials[node.id] = node.combine(
            partials[node.id], part.to(partials[node.id].dtype))


class ContractionUnit(_KernelUnit):
    """An (mul, sum) contraction → kernels.gram when both operands are one
    source (``crossprod(X)`` wraps one physical matrix in two LeafNodes:
    one read), kernels.xty for two (``crossprod(W, X)``)."""

    def __init__(self, node: InnerProdContractNode):
        left, right = node.parents
        super().__init__("gram" if _same_source(left, right) else "xty")
        self.node = node
        self.left_id, self.right_id = left.id, right.id

    def reads(self):
        return [self.left_id, self.right_id]

    def run(self, values, partials, smalls, offset):
        from ..kernels import gram as gram_mod
        x = values[self.left_id]
        part = (gram_mod.gram(x) if self.kernel == "gram"
                else gram_mod.xty(x, values[self.right_id]))
        self._merge(partials, self.node, part)


class WeightedGramUnit(_KernelUnit):
    """``mapply.col(X, w, mul)`` feeding an (mul, sum) contraction of the
    same X → one kernels.wgram call: the reweighted rows never exist."""

    def __init__(self, node: InnerProdContractNode, x_id: int, w_id: int):
        super().__init__("wgram")
        self.node = node
        self.x_id = x_id
        self.w_id = w_id

    def reads(self):
        return [self.x_id, self.w_id]

    def run(self, values, partials, smalls, offset):
        from ..kernels import weighted_gram as wg
        part = wg.wgram(values[self.x_id], values[self.w_id])
        self._merge(partials, self.node, part)


class ApplyAggUnit(_KernelUnit):
    """N apply→agg.col chains over one source → one fused_apply_agg call."""

    def __init__(self, source_id: int, chains, sinks):
        super().__init__("fused_apply_agg")
        self.source_id = source_id
        self.chains = tuple(chains)
        self.sinks = list(sinks)

    def describe(self) -> str:
        return (f"cuda:{self.kernel} chains={len(self.chains)} "
                f"sinks={[s.name for s in self.sinks]}")

    def reads(self):
        return [self.source_id]

    def run(self, values, partials, smalls, offset):
        from ..kernels import fused_apply_agg as faa
        parts = faa.fused_apply_agg(values[self.source_id], self.chains)
        for node, part in zip(self.sinks, parts):
            self._merge(partials, node, part.reshape(node.ncol))


class KMeansUnit(_KernelUnit):
    """The Lloyd-step pattern → one kernels.kmeans_assign call: distances,
    argmin, groupby sums/counts and the objective from one read of X."""

    def __init__(self, *, x_id: int, centers_pos: int, labels: Node,
                 sums: Node, counts: Node | None, wss: Node | None):
        super().__init__("kmeans_assign")
        self.x_id = x_id
        self.centers_pos = centers_pos
        self.labels, self.sums, self.counts, self.wss = (
            labels, sums, counts, wss)

    def describe(self) -> str:
        outs = [self.labels.name, self.sums.name]
        outs += [n.name for n in (self.counts, self.wss) if n is not None]
        return f"cuda:{self.kernel} outs={outs}"

    def reads(self):
        return [self.x_id]

    def run(self, values, partials, smalls, offset):
        from ..kernels import kmeans_assign as ka
        x = values[self.x_id]
        centers = smalls[self.centers_pos].T  # matmul_small stores (p, k)
        lab, sums, cnts, wss = ka.kmeans_assign(x, centers)
        values[self.labels.id] = lab.reshape(-1, 1)
        self._merge(partials, self.sums, sums)
        if self.counts is not None:
            self._merge(partials, self.counts, cnts.reshape(-1, 1))
        if self.wss is not None:
            self._merge(partials, self.wss, wss.reshape(()))


class SpmmUnit(_KernelUnit):
    """A contraction over a sparse (ELL) source → the kernels.spmm family:
    the staged SparseBlock goes to the kernel as it is (nnz-proportional
    traffic).  ``prefix`` holds an absorbed row-local chain computing the
    dense right operand (the IRLS ``w·z`` of XᵀWz), evaluated generically
    first; it never reads the sparse leaf (the matcher declines otherwise).
    A sparse operand that arrives dense raises: there is no dense detour."""

    def __init__(self, kernel: str, node: InnerProdContractNode, *, plan,
                 seg, x_id: int, y_id: int | None = None,
                 w_id: int | None = None, absorb=()):
        super().__init__(kernel)
        self.plan = plan
        self.node = node
        self.x_id = x_id
        self.y_id = y_id
        self.w_id = w_id
        # ``absorb``: segment nodes the kernel computes itself (the wgram
        # reweighting mapply), never evaluated generically.
        self.prefix = tuple(n for n in seg.nodes
                            if n is not node and n not in absorb)

    def reads(self):
        ids = [p.id for n in self.prefix for p in n.parents
               if not isinstance(p, Small)]
        return ids + [i for i in (self.x_id, self.y_id, self.w_id)
                      if i is not None]

    def run(self, values, partials, smalls, offset):
        from ..kernels import spmm
        for n in self.prefix:
            blocks = [smalls[self.plan._small_pos[id(p)]]
                      if isinstance(p, Small) else values[p.id]
                      for p in n.parents]
            values[n.id] = n.block_eval(blocks, offset)
        x = values[self.x_id]
        if not isinstance(x, SparseBlock):
            raise TypeError(
                f"{self.kernel}: the sparse operand arrived as a dense "
                f"{type(x).__name__}; the spmm kernels take its ELL block")
        if self.kernel == "spmm_gram":
            part = spmm.spmm_gram(x.cols, x.vals, ncol=x.ncol)
        elif self.kernel == "spmm_xty":
            part = spmm.spmm_xty(x.cols, x.vals, values[self.y_id],
                                 ncol=x.ncol)
        else:
            part = spmm.spmm_wgram(x.cols, x.vals, values[self.w_id],
                                   ncol=x.ncol)
        self._merge(partials, self.node, part)


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------

class TorchBackend(Backend):
    """Generic lowering: every segment through the dag rules."""

    name = "torch"

    def lower(self, plan, ir) -> LoweredProgram:
        units = [GenericUnit(plan, seg) for seg in ir.segments
                 if seg.kind != "epilogue"]
        return LoweredProgram(plan, ir, self.name, units)


# ---------------------------------------------------------------------------
# cuda backend: the matchers
# ---------------------------------------------------------------------------

def _f32_acc(node) -> bool:
    return dtypes.canon(node.acc_dtype) == torch.float32


def _sparse_leaf(p) -> bool:
    """True when an operand is a leaf over a sparse store: its staged block
    is a SparseBlock, which the dense kernels must never consume."""
    return is_sparse_mat(getattr(p, "mat", None))


def _decline(reasons, seg, msg: str):
    """Record why a matcher passed on a segment it inspected, for
    ``dispatch_report``; ``lower()`` passes no dict."""
    if reasons is not None:
        reasons.setdefault(seg.sid, []).append(msg)


def _source_key(node: Node):
    """Identity of the data a node's partition block carries: distinct
    LeafNodes over one physical matrix compare equal."""
    mat = getattr(node, "mat", None)
    if mat is not None:
        return ("leaf", id(mat))
    return ("node", node.id)


def _same_source(a: Node, b: Node) -> bool:
    return a is b or _source_key(a) == _source_key(b)


def _is_pure_unary_chain(seg):
    """segment = [sapply*, sink]: the unary-name tuple source→sink, or None
    when the absorbed chain is not a linear unary pipeline."""
    names = []
    expect = seg.nodes[-1].parents[0]
    for n in reversed(seg.nodes[:-1]):
        if n is not expect or n.kind != "sapply":
            return None
        names.append(n.fn_info["vudf"].name)
        expect = n.parents[0]
    if isinstance(expect, Small):
        return None
    return tuple(reversed(names))


def _match_spmm(plan, ir, claimed, reasons=None):
    """Contraction over a sparse (ELL) source → kernels.spmm; runs first, so
    a SparseBlock never reaches the dense gram/xty/wgram kernels.  Shapes:

    * ``crossprod(Xs)``         — one-node segment, both operands one sparse
      source → ``spmm_gram``;
    * ``crossprod(Xs * w, Xs)`` — the absorbed ``mapply_col`` reweighting of
      the contraction's own sparse source → ``spmm_wgram`` (sparse IRLS
      XᵀWX);
    * ``crossprod(Xs, Y)``      — sparse left against a dense right; the
      segment may have absorbed a row-local prefix computing Y (IRLS
      XᵀWz's ``w·z``), which the unit evaluates generically first.
    """
    units = {}
    for seg in ir.segments:
        if seg.sid in claimed or seg.kind != "contraction":
            continue
        node = seg.root
        if not isinstance(node, InnerProdContractNode):
            continue
        left, right = node.parents
        l_sp, r_sp = _sparse_leaf(left), _sparse_leaf(right)
        if not (l_sp or r_sp):
            continue
        if node.mul.name != "mul" or node.add.name != "sum":
            _decline(reasons, seg,
                     f"sparse operand under a ({node.mul.name},"
                     f"{node.add.name}) semiring: spmm covers (mul,sum) "
                     "only")
            continue
        if not _f32_acc(node):
            _decline(reasons, seg, "sparse operand with 64-bit "
                     "accumulation: spmm kernels accumulate in f32")
            continue
        if len(seg.nodes) == 1:
            if l_sp and r_sp and _same_source(left, right):
                claimed.add(seg.sid)
                units[seg.sid] = SpmmUnit("spmm_gram", node, plan=plan,
                                          seg=seg, x_id=left.id)
                continue
            if l_sp and r_sp:
                _decline(reasons, seg, "two distinct sparse operands: "
                         "spmm expects one sparse source")
                continue
            if l_sp and not isinstance(right, Small) \
                    and dtypes.is_floating(right.dtype):
                claimed.add(seg.sid)
                units[seg.sid] = SpmmUnit("spmm_xty", node, plan=plan,
                                          seg=seg, x_id=left.id,
                                          y_id=right.id)
                continue
            _decline(reasons, seg,
                     "sparse right operand: spmm computes sparseᵀ·dense "
                     "(put the sparse matrix on the left)" if r_sp else
                     "sparse left against a non-float right operand")
            continue
        # Multi-node segment: the wgram shape, or an absorbed dense prefix
        # computing the right operand of an xty.
        if len(seg.nodes) == 2:
            m = seg.nodes[0]
            other = right if left is m else left if right is m else None
            if (isinstance(m, MapNode) and m.kind == "mapply_col"
                    and m.fn_info["vudf"].name == "mul"
                    and other is not None
                    and not isinstance(other, Small)):
                xx, ww = m.parents
                if (_sparse_leaf(xx) and not _sparse_leaf(ww)
                        and not isinstance(ww, Small)
                        and _same_source(xx, other)
                        and dtypes.is_floating(ww.dtype)):
                    claimed.add(seg.sid)
                    units[seg.sid] = SpmmUnit("spmm_wgram", node, plan=plan,
                                              seg=seg, x_id=xx.id,
                                              w_id=ww.id, absorb=(m,))
                    continue
        if l_sp and not isinstance(right, Small):
            prefix = [n for n in seg.nodes if n is not node]
            if any(_sparse_leaf(p) for n in prefix for p in n.parents):
                _decline(reasons, seg, "absorbed prefix reads the sparse "
                         "source: spmm feeds the leaf to the kernel "
                         "unseen")
                continue
            claimed.add(seg.sid)
            units[seg.sid] = SpmmUnit("spmm_xty", node, plan=plan, seg=seg,
                                      x_id=left.id, y_id=right.id)
            continue
        _decline(reasons, seg, "sparse contraction shape not covered by "
                 "spmm (gram / xty / weighted-gram)")
    return units


def _match_contractions(plan, ir, claimed, reasons=None):
    units = {}
    for seg in ir.segments:
        if seg.sid in claimed or seg.kind != "contraction":
            continue
        node = seg.root
        if len(seg.nodes) != 1 or not isinstance(node, InnerProdContractNode):
            continue
        if any(_sparse_leaf(p) for p in node.parents):
            _decline(reasons, seg, "sparse operand: dense gram/xty "
                     "kernels read dense tiles")
            continue
        if node.mul.name != "mul" or node.add.name != "sum":
            _decline(reasons, seg,
                     f"({node.mul.name},{node.add.name}) semiring: "
                     "gram/xty cover (mul,sum) only")
            continue
        if not _f32_acc(node):
            continue
        if any(isinstance(p, Small) for p in node.parents):
            _decline(reasons, seg, "small broadcast operand: nothing to "
                     "stream through the contraction kernel")
            continue
        if not all(dtypes.is_floating(p.dtype) for p in node.parents):
            _decline(reasons, seg, "non-float operand: gram/xty are "
                     "floating kernels")
            continue
        claimed.add(seg.sid)
        units[seg.sid] = ContractionUnit(node)
    return units


def _match_weighted_gram(plan, ir, claimed, reasons=None):
    """crossprod(X * w, X), either orientation → kernels.wgram."""
    units = {}
    for seg in ir.segments:
        if seg.sid in claimed or seg.kind != "contraction":
            continue
        if len(seg.nodes) != 2:
            continue
        m, node = seg.nodes
        if not isinstance(node, InnerProdContractNode) or \
                not isinstance(m, MapNode) or m.kind != "mapply_col":
            continue
        if any(_sparse_leaf(p) for p in node.parents + m.parents):
            _decline(reasons, seg, "sparse operand: the dense wgram "
                     "kernel reads dense tiles")
            continue
        if node.mul.name != "mul" or node.add.name != "sum":
            continue
        if m.fn_info["vudf"].name != "mul":
            _decline(reasons, seg, "absorbed mapply_col is not a mul "
                     "reweighting: not the XᵀWX shape")
            continue
        if not _f32_acc(node):
            continue
        left, right = node.parents
        other = right if left is m else left if right is m else None
        if other is None or isinstance(other, Small):
            continue
        xx, ww = m.parents
        if isinstance(xx, Small) or isinstance(ww, Small):
            continue
        if not _same_source(xx, other):
            _decline(reasons, seg, "reweighted matrix differs from the "
                     "contraction's other operand: not XᵀWX")
            continue
        if not all(dtypes.is_floating(p.dtype) for p in (xx, ww, other)):
            continue
        claimed.add(seg.sid)
        units[seg.sid] = WeightedGramUnit(node, xx.id, ww.id)
    return units


def _chain_acc_dtype(node) -> str | None:
    """Kernel accumulator dtype for an agg.col sink, or None if ineligible:
    f32 for float accumulation, i32 (exact) for integers."""
    acc = dtypes.canon(node.acc_dtype)
    if acc == torch.float32:
        return "float32"
    if dtypes.kind(acc) == "i":
        return "int32"
    return None


def _chain_source_ok(source) -> bool:
    """Sources of at most 4 bytes, integer or float (bool has no sum/min/max
    algebra in the kernel)."""
    dt = dtypes.canon(source.dtype)
    return dtypes.kind(dt) in ("i", "f") and dtypes.itemsize(dt) <= 4


def _match_apply_agg(plan, ir, claimed, reasons=None):
    _AGG_MAP = {"sum": "sum", "min": "min", "max": "max",
                "count": "count", "count_nonzero": "count_nonzero"}
    from ..kernels.fused_apply_agg import CHAIN_UNARIES
    by_source: dict = {}
    for seg in ir.segments:
        if seg.sid in claimed or seg.kind != "sink_update":
            continue
        node = seg.root
        if node.kind != "agg_col" or node.agg.name not in _AGG_MAP:
            continue
        acc = _chain_acc_dtype(node)
        if acc is None:
            continue
        unaries = _is_pure_unary_chain(seg)
        if unaries is None or any(u not in CHAIN_UNARIES for u in unaries):
            continue
        source = seg.nodes[0].parents[0]
        if isinstance(source, Small) or not _chain_source_ok(source):
            continue
        if _sparse_leaf(source):
            _decline(reasons, seg, "sparse source: fused_apply_agg "
                     "streams dense tiles (implicit zeros take part in "
                     "the reduction through the generic rules)")
            continue
        by_source.setdefault(_source_key(source), []).append(
            (seg, source.id, (unaries, _AGG_MAP[node.agg.name], acc)))
    units = {}
    for entries in by_source.values():
        segs = [seg for seg, _, _ in entries]
        chains = tuple(chain for _, _, chain in entries)
        for seg in segs:
            claimed.add(seg.sid)
        units[segs[0].sid] = ApplyAggUnit(
            entries[0][1], chains, [seg.root for seg in segs])
    return units


def _single_node_seg(ir, node, kind=None):
    for seg in ir.segments:
        if seg.root is node and len(seg.nodes) == 1:
            if kind is None or seg.kind == kind:
                return seg
    return None


def _match_kmeans(plan, ir, claimed, reasons=None):
    """distances (squared_diff,sum) → which.min labels → groupby sums
    [+ counts, + wss] → kernels.kmeans_assign."""
    units = {}
    value_roots = {n.id for n in plan.row_local_roots + plan.saves}
    for seg in ir.segments:
        if seg.sid in claimed or seg.kind != "row_local":
            continue
        labels = seg.root
        if (len(seg.nodes) != 1 or not isinstance(labels, MapNode)
                or labels.kind != "agg_row"
                or labels.fn_info["vudf"].name != "which.min"):
            continue
        d = labels.parents[0]
        if (isinstance(d, Small) or not isinstance(d, MapNode)
                or d.kind != "matmul_small"
                or d.fn_info["mul"].name != "squared_diff"
                or d.fn_info["add"].name != "sum"
                or d.id in value_roots):
            continue
        x = d.parents[0]
        centers = d.parents[1]
        if (isinstance(x, Small) or not isinstance(centers, Small)
                or not dtypes.is_floating(x.dtype)):
            continue
        if _sparse_leaf(x):
            _decline(reasons, seg, "sparse source: kmeans_assign reads "
                     "dense tiles")
            continue
        d_seg = _single_node_seg(ir, d)
        if d_seg is None or d_seg.sid in claimed:
            continue

        d_consumers = ir.consumers.get(d.id, [])
        mind = None
        ok = True
        for c in d_consumers:
            if c is labels:
                continue
            if (isinstance(c, MapNode) and c.kind == "agg_row"
                    and c.fn_info["vudf"].name == "min" and mind is None
                    and c.id not in value_roots):
                mind = c
            else:
                ok = False
        if not ok:
            continue

        lab_consumers = ir.consumers.get(labels.id, [])
        sums = counts = None
        for c in lab_consumers:
            if (isinstance(c, GroupByRowNode) and c.agg.name == "sum"
                    and _same_source(c.parents[0], x)
                    and c.parents[1] is labels
                    and _f32_acc(c) and sums is None):
                sums = c
            elif (isinstance(c, GroupByRowNode) and c.agg.name == "count"
                  and c.parents[0] is labels and c.parents[1] is labels
                  and counts is None):
                counts = c
            else:
                ok = False
        if not ok or sums is None:
            continue
        sums_seg = _single_node_seg(ir, sums, "sink_update")
        counts_seg = (_single_node_seg(ir, counts, "sink_update")
                      if counts is not None else None)
        if sums_seg is None or (counts is not None and counts_seg is None):
            continue
        if counts is not None and sums.num_groups != counts.num_groups:
            continue

        wss = wss_seg = None
        if mind is not None:
            mind_consumers = ir.consumers.get(mind.id, [])
            if (len(mind_consumers) == 1
                    and isinstance(mind_consumers[0], AggFullNode)
                    and mind_consumers[0].agg.name == "sum"
                    and _f32_acc(mind_consumers[0])):
                wss = mind_consumers[0]
                for s in ir.segments:
                    if s.root is wss and [n.id for n in s.nodes] == \
                            [mind.id, wss.id]:
                        wss_seg = s
            if wss is None or wss_seg is None or wss_seg.sid in claimed:
                continue

        group = [seg, d_seg, sums_seg] + \
            [s for s in (counts_seg, wss_seg) if s is not None]
        if any(s.sid in claimed for s in group):
            continue
        for s in group:
            claimed.add(s.sid)
        units[min(s.sid for s in group)] = KMeansUnit(
            x_id=x.id, centers_pos=plan._small_pos[id(centers)],
            labels=labels, sums=sums, counts=counts, wss=wss)
    return units


def dispatch_report(plan, ir, backend: str) -> dict[int, str]:
    """Per-segment dispatch decision: replay the backend's matchers over a
    pass's IR (claiming but not lowering) and say which kernel claimed each
    segment — or why it runs the generic rules."""
    backend = resolve_backend(backend)
    report: dict[int, str] = {}
    claimed: set[int] = set()
    reasons: dict[int, list] = {}
    if backend == "cuda":
        for matcher in CudaBackend.MATCHERS:
            before = set(claimed)
            placed = matcher(plan, ir, claimed, reasons=reasons)
            kernels = sorted({u.kernel for u in placed.values()})
            mname = matcher.__name__.lstrip("_")
            for sid, unit in placed.items():
                report[sid] = f"cuda:{unit.kernel} (claimed by {mname})"
            for sid in claimed - before:
                if sid not in placed:
                    report[sid] = (f"fused into cuda:{'/'.join(kernels)} "
                                   f"(claimed by {mname})")
    for seg in ir.segments:
        if seg.sid in report:
            continue
        if seg.kind == "epilogue":
            report[seg.sid] = "post-merge epilogue (single launch per pass)"
        elif backend != "cuda":
            report[seg.sid] = "torch generic rules"
        elif dtypes.itemsize(seg.dtype) >= 8:
            report[seg.sid] = ("generic rules (64-bit dtype: kernels keep "
                               "full precision on the torch path)")
        elif seg.sid in reasons:
            why = "; ".join(dict.fromkeys(reasons[seg.sid]))
            report[seg.sid] = f"generic rules (declined: {why})"
        else:
            report[seg.sid] = "generic rules (no kernel pattern matched)"
    return report


class CudaBackend(Backend):
    """Lower eligible segments onto the Hopper kernels; generic rules for
    the rest.  Matchers run in order and claim segments by sid."""

    name = "cuda"
    # _match_spmm runs first: a sparse segment either lowers onto the spmm
    # kernels or records why not — the dense kernels never see an ELL block.
    MATCHERS = [_match_spmm, _match_kmeans, _match_weighted_gram,
                _match_contractions, _match_apply_agg]

    def lower(self, plan, ir) -> LoweredProgram:
        claimed: set[int] = set()
        placed: dict[int, object] = {}
        for matcher in self.MATCHERS:
            placed.update(matcher(plan, ir, claimed))
        units = []
        for seg in ir.segments:
            if seg.kind == "epilogue":
                continue
            if seg.sid in placed:
                units.append(placed[seg.sid])
            elif seg.sid not in claimed:
                units.append(GenericUnit(plan, seg))
        return LoweredProgram(plan, ir, self.name, units)


register_backend("torch", TorchBackend())
register_backend("cuda", CudaBackend())
