"""Expression DAG for lazy evaluation (paper §III-E), PyTorch port of
repro.core.dag.

Row-local nodes implement ``block_eval``; sinks (nodes that contract the long
dimension) implement identity → per-partition update → pairwise combine →
finalize.  The node classes, their classification and the multi-pass
schedule are the reference's; the block rules run on torch tensors.

PyTorch runs eagerly, so a broadcast-then-reduce rule that XLA would fuse
into one loop (a general-semiring inner product: (rows, k, q) before the
reduction over k) is evaluated here in row chunks that bound the temporary
to ``_BROADCAST_ELEMS`` elements, with the same arithmetic per row.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence, Union

import torch

from . import dtypes, vudf as vudf_mod
from .matrix import FMMatrix
from .sparse import SparseBlock

_ids = itertools.count()

#: Ops that only ever run in the plan EPILOGUE (post-sink small-tier math).
EPILOGUE_ONLY_KINDS = frozenset({"solve"})

#: Largest broadcast temporary (elements) a general-semiring rule builds at
#: once before reducing it.
_BROADCAST_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------

class Small:
    """A broadcast operand: a scalar or a small tensor replicated to every
    partition.  Compared by identity (the plan registry keys on ``id``)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    @property
    def dtype(self):
        if isinstance(self.value, torch.Tensor):
            return dtypes.canon(self.value.dtype)
        if hasattr(self.value, "dtype"):
            return dtypes.canon(self.value.dtype)
        if isinstance(self.value, bool):
            return torch.bool
        if isinstance(self.value, int):
            return dtypes.canon(torch.int64)
        return torch.float32


Operand = Union["Node", Small]


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

class Node:
    """Base DAG node.  ``shape`` is the logical (nrow, ncol) of the output."""

    kind: str = "?"

    def __init__(self, shape, dtype, parents: Sequence[Operand], name=""):
        self.id = next(_ids)
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = dtypes.canon(dtype)
        self.parents = list(parents)
        self.name = name or f"{self.kind}#{self.id}"
        # None = stay virtual; 'device' = keep the materialized value.
        self.save: Optional[str] = None

    @property
    def is_sink(self) -> bool:
        return False

    @property
    def nrow(self):
        return self.shape[0]

    @property
    def ncol(self):
        return self.shape[1]

    def parent_nodes(self):
        return [p for p in self.parents if isinstance(p, Node)]

    def flops_per_row(self) -> float:
        return 0.0

    def __repr__(self):
        return (f"<{self.kind} {self.name} {self.shape} "
                f"{dtypes.name(self.dtype)}>")


class LeafNode(Node):
    kind = "leaf"

    def __init__(self, mat: FMMatrix):
        super().__init__(mat.shape, mat.dtype, [], name=mat.name or None)
        self.mat = mat

    def block_eval(self, blocks, offset):
        raise AssertionError("leaves are sliced by the executor, not evaluated")


class MapNode(Node):
    """Row-local computation node.  ``op`` dispatches the eval rule."""

    def __init__(self, op: str, shape, dtype, parents, fn_info, name=""):
        self.kind = op
        super().__init__(shape, dtype, parents, name)
        self.fn_info = fn_info

    def flops_per_row(self) -> float:
        info = self.fn_info
        op = self.kind
        if op in ("sapply", "mapply", "mapply_row", "mapply_col"):
            return info["vudf"].flops * self.ncol
        if op == "agg_row":
            return info["vudf"].flops * self.parents[0].shape[1]
        if op == "matmul_small":
            k = self.parents[0].shape[1]
            return 2.0 * k * self.ncol
        if op == "groupby_col":
            return self.parents[0].shape[1]
        return 0.0

    def block_eval(self, blocks, offset):
        """blocks: per-parent partition tensors (Small operands appear as
        their raw values).  offset: global row offset of this partition."""
        op = self.kind
        info = self.fn_info
        if op == "sapply":
            return info["vudf"].fn(blocks[0])
        if op == "mapply":
            return info["vudf"].fn(blocks[0], blocks[1])
        if op == "mapply_row":
            return info["vudf"].fn(blocks[0], blocks[1].reshape(1, -1))
        if op == "mapply_col":
            return info["vudf"].fn(blocks[0], blocks[1].reshape(-1, 1))
        if op == "agg_row":
            agg = info["vudf"]
            part = agg.aggregate(blocks[0], 1, 0)
            return agg.finalize(part).reshape(-1, 1)
        if op == "cbind":
            cols = [b if b.ndim == 2 else b.reshape(-1, 1) for b in blocks]
            return torch.cat(cols, dim=1)
        if op == "matmul_small":
            return _inner_prod_block(blocks[0], blocks[1],
                                     info["mul"], info["add"], self.dtype)
        if op == "groupby_col":
            agg_name = info["vudf"].name
            labels = blocks[1].reshape(-1).to(torch.int64)
            k = info["num_groups"]
            base = blocks[0]
            if agg_name not in ("sum", "count", "count_nonzero"):
                raise NotImplementedError(
                    f"groupby_col with agg {agg_name!r}; supported: sum/count")
            if agg_name == "count":
                base = torch.ones_like(base)
            elif agg_name == "count_nonzero":
                base = (base != 0).to(base.dtype)
            onehot = torch.nn.functional.one_hot(labels, k).to(base.dtype)
            if base.is_floating_point():
                return base @ onehot
            return (base[:, :, None] * onehot[None]).sum(1).to(base.dtype)
        if op == "solve":
            # Epilogue-only: a·x = b on the merged sink values, then one
            # same-precision iterative-refinement step (the system is p×p,
            # so the extra solve is free).
            a = blocks[0].to(self.dtype)
            b = blocks[1]
            if not isinstance(b, torch.Tensor):
                b = torch.as_tensor(b, device=a.device)
            if b.ndim == 1:
                b = b.reshape(-1, 1)
            elif b.shape[0] != a.shape[0]:
                b = b.reshape(a.shape[0], -1)
            b = b.to(self.dtype)
            x = _solve_or_nan(a, b)
            r = b - a @ x
            return x + _solve_or_nan(a, r)
        raise AssertionError(f"unknown map op {op}")


def _solve_or_nan(a, b):
    """a⁻¹b, NaN where the factorization found a singular a: like the
    reference's on-device ``jnp.linalg.solve``, a singular system yields
    non-finite values rather than an exception (and no host round trip)."""
    x, info = torch.linalg.solve_ex(a, b)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _row_chunks(n: int, per_row: int):
    step = max(1, _BROADCAST_ELEMS // max(1, per_row))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def _inner_prod_block(a_blk, b_small, mul: vudf_mod.BinaryVUDF,
                      add: vudf_mod.AggVUDF, out_dtype):
    """inner.prod(tall, small): t = f1(A_ik, B_kj); C_ij = f2-reduce_k t.
    The (mul, sum) semiring on floats is a matrix product; other semirings
    evaluate f1 on a broadcast (rows, k, q) tile, row chunk by row chunk.

    A sparse (ELL) left operand with the (mul, sum) semiring takes the gather
    path — out[i,j] = Σ_k vals[i,k]·B[cols[i,k], j] — so ``X @ beta`` over a
    one-hot matrix does nnz-proportional work; other semirings densify the
    block first (implicit zeros take part in, say, a min reduction)."""
    if isinstance(a_blk, SparseBlock):
        if mul.name == "mul" and add.name == "sum":
            return a_blk.matmul_small(b_small, out_dtype, _BROADCAST_ELEMS)
        a_blk = a_blk.todense()
    if mul.name == "mul" and add.name == "sum" and dtypes.is_floating(out_dtype):
        return torch.matmul(a_blk, b_small).to(out_dtype)
    n = a_blk.shape[0]
    per_row = a_blk.shape[1] * b_small.shape[1]
    outs = []
    for s, e in _row_chunks(n, per_row):
        t = mul.fn(a_blk[s:e, :, None], b_small[None, :, :])
        outs.append(add.finalize(add.aggregate(t, 1, 0)).to(out_dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


class SinkNode(Node):
    """Long-dimension-contracting node: identity → per-partition update →
    pairwise combine → finalize."""

    @property
    def is_sink(self) -> bool:
        return True

    def identity(self):
        raise NotImplementedError

    def block_update(self, acc, blocks, offset):
        raise NotImplementedError

    def combine(self, a, b):
        raise NotImplementedError

    def finalize(self, acc):
        return acc


class AggFullNode(SinkNode):
    kind = "agg"

    def __init__(self, parent: Node, agg: vudf_mod.AggVUDF):
        out_dt = agg.out_dtype(parent.dtype)
        super().__init__((1, 1), out_dt, [parent], name=f"agg[{agg.name}]")
        self.agg = agg
        self.acc_dtype = _acc_dtype(agg, parent.dtype)

    def flops_per_row(self) -> float:
        return self.agg.flops * self.parents[0].shape[1]

    def identity(self):
        return self.agg.identity((), self.acc_dtype)

    def block_update(self, acc, blocks, offset):
        part = self.agg.aggregate(blocks[0], None, offset)
        return self.agg.combine(acc, part)

    def combine(self, a, b):
        return self.agg.combine(a, b)

    def finalize(self, acc):
        return torch.as_tensor(self.agg.finalize(acc)).reshape(1, 1)


class AggColNode(SinkNode):
    """Per-column aggregation over the long (row) dimension: C_j."""

    kind = "agg_col"

    def __init__(self, parent: Node, agg: vudf_mod.AggVUDF):
        out_dt = agg.out_dtype(parent.dtype)
        super().__init__((1, parent.ncol), out_dt, [parent],
                         name=f"agg.col[{agg.name}]")
        self.agg = agg
        self.acc_dtype = _acc_dtype(agg, parent.dtype)

    def flops_per_row(self) -> float:
        return self.agg.flops * self.parents[0].shape[1]

    def identity(self):
        return self.agg.identity((self.ncol,), self.acc_dtype)

    def block_update(self, acc, blocks, offset):
        part = self.agg.aggregate(blocks[0], 0, offset)
        return self.agg.combine(acc, part)

    def combine(self, a, b):
        return self.agg.combine(a, b)

    def finalize(self, acc):
        return self.agg.finalize(acc).reshape(1, -1)


class GroupByRowNode(SinkNode):
    """fm.groupby.row: CC_{k,j} = agg over rows i with labels[i]==k.  Labels
    outside [0, num_groups) are dropped, like the reference's
    ``.at[...](mode="drop")``."""

    kind = "groupby_row"

    _AT_OPS = {"sum": "sum", "count": "sum", "count_nonzero": "sum",
               "min": "amin", "max": "amax"}

    def __init__(self, parent: Node, labels: Node, agg: vudf_mod.AggVUDF,
                 num_groups: int):
        if agg.name not in self._AT_OPS:
            raise NotImplementedError(
                f"groupby.row supports {sorted(self._AT_OPS)} aggregation, "
                f"got {agg.name!r}")
        out_dt = agg.out_dtype(parent.dtype)
        super().__init__((num_groups, parent.ncol), out_dt, [parent, labels],
                         name=f"groupby.row[{agg.name}]")
        self.agg = agg
        self.num_groups = num_groups
        self.acc_dtype = _acc_dtype(agg, parent.dtype)

    def flops_per_row(self) -> float:
        return self.parents[0].shape[1]

    def identity(self):
        return self.agg.identity((self.num_groups, self.ncol), self.acc_dtype)

    def block_update(self, acc, blocks, offset):
        vals = blocks[0]
        labels = blocks[1].reshape(-1).to(torch.int64)
        if self.agg.name == "count":
            vals = torch.ones_like(vals, dtype=self.acc_dtype)
        elif self.agg.name == "count_nonzero":
            vals = (vals != 0).to(self.acc_dtype)
        else:
            vals = vals.to(self.acc_dtype)
        keep = (labels >= 0) & (labels < self.num_groups)
        if not bool(keep.all()):
            labels, vals = labels[keep], vals[keep]
        if self._AT_OPS[self.agg.name] == "sum" and vals.is_floating_point():
            # A float scatter-add accumulates each group's rows one by one
            # (atomics on a card): at tens of millions of rows per group its
            # rounding drifts by percents.  A one-hot product per row chunk
            # sums the same terms blockwise.
            for s, e in _row_chunks(vals.shape[0], self.num_groups):
                onehot = torch.nn.functional.one_hot(
                    labels[s:e], self.num_groups).to(vals.dtype)
                acc = acc + onehot.T @ vals[s:e]
            return acc
        idx = labels.reshape(-1, 1).expand(-1, vals.shape[1])
        return acc.scatter_reduce(0, idx, vals, self._AT_OPS[self.agg.name],
                                  include_self=True)

    def combine(self, a, b):
        return self.agg.combine(a, b)

    def finalize(self, acc):
        return self.agg.finalize(acc)


class InnerProdContractNode(SinkNode):
    """inner.prod contracting the long dimension: C = f2-reduce_i
    f1(tA_i, B_i) — ``t(X) %*% Y``, the Gram / XᵀY sinks."""

    kind = "inner_prod"

    def __init__(self, left: Node, right: Node, mul: vudf_mod.BinaryVUDF,
                 add: vudf_mod.AggVUDF):
        out_dt = add.out_dtype(mul.out_dtype(left.dtype, right.dtype))
        super().__init__((left.ncol, right.ncol), out_dt, [left, right],
                         name=f"inner[{mul.name},{add.name}]")
        self.mul, self.add = mul, add
        self.acc_dtype = _acc_dtype(add, mul.out_dtype(left.dtype, right.dtype))

    def flops_per_row(self) -> float:
        return 2.0 * self.shape[0] * self.shape[1]

    def identity(self):
        return self.add.identity(self.shape, self.acc_dtype)

    def block_update(self, acc, blocks, offset):
        a_blk, b_blk = blocks
        if (self.mul.name == "mul" and self.add.name == "sum"
                and dtypes.is_floating(self.acc_dtype)):
            part = torch.matmul(a_blk.T.to(self.acc_dtype),
                                b_blk.to(self.acc_dtype))
            return self.add.combine(acc, part)
        per_row = a_blk.shape[1] * b_blk.shape[1]
        for s, e in _row_chunks(a_blk.shape[0], per_row):
            t = self.mul.fn(a_blk[s:e, :, None], b_blk[s:e, None, :])
            acc = self.add.combine(acc, self.add.aggregate(t, 0, offset + s))
        return acc

    def combine(self, a, b):
        return self.add.combine(a, b)

    def finalize(self, acc):
        return self.add.finalize(acc).to(self.dtype)


def _acc_dtype(agg: vudf_mod.AggVUDF, in_dtype):
    """Accumulator dtype: bf16 accumulates in f32."""
    out = agg.out_dtype(in_dtype)
    return torch.float32 if out == torch.bfloat16 else out


# ---------------------------------------------------------------------------
# Graph utilities (identical to the reference)
# ---------------------------------------------------------------------------

def as_node(mat_or_node) -> Node:
    if isinstance(mat_or_node, Node):
        return mat_or_node
    if isinstance(mat_or_node, FMMatrix):
        if mat_or_node.is_virtual:
            return mat_or_node.node
        return LeafNode(mat_or_node)
    raise TypeError(type(mat_or_node))


def wrap(node: Node, name: str = "") -> FMMatrix:
    return FMMatrix(node.shape, node.dtype, node=node, name=name or node.name)


def schedule_passes(order: Sequence[Node], is_source, long_dim: int):
    """Multi-pass schedule of a DAG cut: every executable node gets a role
    ('loop' | 'epi') and a pass number (see repro.core.dag.schedule_passes).
    Returns ``(roles, passno)`` keyed by node id."""
    roles: dict[int, str] = {}
    passno: dict[int, int] = {}
    for n in order:
        if is_source(n):
            continue
        has_stream = False
        stream_pass = 0
        merged_pass = -1
        for p in n.parents:
            if isinstance(p, Small):
                continue
            if is_source(p):
                if p.shape[0] == long_dim and max(p.shape) > 1:
                    has_stream = True
                continue
            if roles[p.id] == "loop" and not p.is_sink:
                has_stream = True
                stream_pass = max(stream_pass, passno[p.id])
            else:
                merged_pass = max(merged_pass, passno[p.id])
        if n.kind in EPILOGUE_ONLY_KINDS:
            for p in n.parents:
                if (isinstance(p, Node) and not is_source(p)
                        and roles[p.id] == "loop" and not p.is_sink):
                    raise ValueError(
                        f"epilogue op {n.name} consumes the streaming "
                        f"intermediate {p.name}: {n.kind} may only touch "
                        f"aggregation results, small operands or other "
                        f"epilogue values inside one DAG — materialize "
                        f"{p.name} first (it needs its own pass)")
            roles[n.id] = "epi"
            passno[n.id] = max(merged_pass, 0)
        elif not has_stream and merged_pass >= 0:
            roles[n.id] = "epi"
            passno[n.id] = merged_pass
        else:
            roles[n.id] = "loop"
            passno[n.id] = max(stream_pass, merged_pass + 1)
    return roles, passno


def post_sink_ids(order: Sequence[Node], is_source=None) -> set:
    """Ids of nodes downstream of a sink within ``order``: the epilogue."""
    src = is_source or (lambda n: isinstance(n, LeafNode)
                        or getattr(n, "cached_store", None) is not None)
    post: set = set()
    for n in order:
        if src(n):
            continue
        if n.kind in EPILOGUE_ONLY_KINDS or any(
                isinstance(p, Node) and not src(p)
                and (p.is_sink or p.id in post)
                for p in n.parents):
            post.add(n.id)
    return post


def long_dim_of(roots: Sequence[Node]) -> int:
    """All matrices in a DAG share one streaming (row) dimension."""
    seen: set = set()
    order: list[Node] = []

    def visit(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        if getattr(n, "cached_store", None) is None:
            for p in n.parent_nodes():
                visit(p)
        order.append(n)

    for r in roots:
        visit(r)
    post = post_sink_ids(order)
    consumers: dict = {}
    for n in order:
        for p in n.parent_nodes():
            consumers.setdefault(p.id, []).append(n)
    dims = set()
    for n in order:
        if n.id in post:
            continue
        if (isinstance(n, LeafNode)
                or getattr(n, "cached_store", None) is not None):
            cons = consumers.get(n.id, [])
            if cons and all(c.id in post for c in cons):
                continue
            if max(n.shape) > 1:
                dims.add(n.shape[0])
        elif not n.is_sink:
            dims.add(n.shape[0])
        else:
            for p in n.parent_nodes():
                if not p.is_sink and p.id not in post:
                    dims.add(p.shape[0])
    dims.discard(1)
    if len(dims) > 1:
        raise ValueError(
            f"all matrices in one DAG must share the streaming (row) "
            f"dimension; got {sorted(dims)}")
    return dims.pop() if dims else 1
