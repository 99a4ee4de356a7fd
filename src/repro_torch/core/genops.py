"""The Generalized Matrix Operators (GenOps, paper Table I), PyTorch port of
repro.core.genops.

Every GenOp is lazy: it returns a virtual FMMatrix wrapping a DAG node.
Dtype mismatches insert lazy ``sapply`` cast nodes, and scalar operands take
the broadcast forms.  Small operands (vectors, small matrices) are tensors on
the engine's device, in their canonical dtype.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import dtypes, vudf as vudf_mod
from .dag import (AggColNode, AggFullNode, GroupByRowNode,
                  InnerProdContractNode, LeafNode, MapNode, Node, Small,
                  as_node, wrap)
from .matrix import FMMatrix, to_device

MatLike = Union[FMMatrix, Node]


def _u(f) -> vudf_mod.UnaryVUDF:
    return vudf_mod.unary(f) if isinstance(f, str) else f


def _b(f) -> vudf_mod.BinaryVUDF:
    return vudf_mod.binary(f) if isinstance(f, str) else f


def _a(f) -> vudf_mod.AggVUDF:
    return vudf_mod.agg(f) if isinstance(f, str) else f


def _cast(node: Node, to_dtype) -> Node:
    if node.dtype == dtypes.canon(to_dtype):
        return node
    cv = vudf_mod.unary(f"cast_{dtypes.name(dtypes.canon(to_dtype))}")
    return MapNode("sapply", node.shape, to_dtype, [node], {"vudf": cv},
                   name=f"cast({node.name})")


def _promote2(x: Node, y: Node):
    dt = dtypes.promote(x.dtype, y.dtype)
    return _cast(x, dt), _cast(y, dt), dt


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, bool, np.number)) or (
        hasattr(v, "shape") and tuple(getattr(v, "shape", ())) == ())


def _small_array(v) -> torch.Tensor:
    """Coerce a small operand (R vector / small matrix) to a device tensor."""
    if isinstance(v, FMMatrix):
        return v.logical_data()
    return to_device(v)


def _scalar(v):
    """A scalar operand as a python number (0-d arrays included)."""
    if isinstance(v, torch.Tensor):
        return v.item()
    if isinstance(v, np.ndarray) or isinstance(v, np.number):
        return v.item()
    return v


# ---------------------------------------------------------------------------
# apply family
# ---------------------------------------------------------------------------

def sapply(mat: MatLike, f) -> FMMatrix:
    """Element-wise unary: CC_ij = f(AA_ij)."""
    f = _u(f)
    x = as_node(mat)
    node = MapNode("sapply", x.shape, f.out_dtype(x.dtype), [x], {"vudf": f})
    return wrap(node)


def mapply(a: MatLike, b, f) -> FMMatrix:
    """Element-wise binary: CC_ij = f(AA_ij, BB_ij); a scalar operand on
    either side selects the broadcast form."""
    f = _b(f)
    if _is_scalar(b):
        x = as_node(a)
        s = Small(_scalar(b))
        dt = f.out_dtype(x.dtype, s.dtype)
        x = _cast(x, dtypes.promote(x.dtype, s.dtype))
        node = MapNode("mapply", x.shape, dt, [x, s], {"vudf": f})
        return wrap(node)
    if _is_scalar(a):
        y = as_node(b)
        s = Small(_scalar(a))
        dt = f.out_dtype(s.dtype, y.dtype)
        y = _cast(y, dtypes.promote(s.dtype, y.dtype))
        flip = vudf_mod.BinaryVUDF(f"{f.name}.sv", lambda u, v, _f=f.fn: _f(v, u),
                                   f.flops, f.dtype_rule, f.commutative)
        node = MapNode("mapply", y.shape, dt, [y, s], {"vudf": flip})
        return wrap(node)
    x, y = as_node(a), as_node(b)
    if x.shape != y.shape:
        raise ValueError(f"mapply shape mismatch: {x.shape} vs {y.shape}")
    x, y, _ = _promote2(x, y)
    node = MapNode("mapply", x.shape, f.out_dtype(x.dtype, y.dtype), [x, y],
                   {"vudf": f})
    return wrap(node)


def mapply_row(a: MatLike, vec, f) -> FMMatrix:
    """CC_ij = f(AA_ij, B_j): the vector pairs with each row (length ncol).
    A virtual vector stays a lazy DAG parent (the multi-pass schedule)."""
    f = _b(f)
    x = as_node(a)
    if isinstance(vec, Node) or (isinstance(vec, FMMatrix) and vec.is_virtual):
        v = as_node(vec)
        if min(v.shape) != 1 or max(v.shape) != x.ncol:
            raise ValueError(
                f"mapply.row vector shape {v.shape} does not broadcast "
                f"across ncol {x.ncol}")
        xx, vv, dt = _promote2(x, v)
        node = MapNode("mapply_row", x.shape, f.out_dtype(dt, dt), [xx, vv],
                       {"vudf": f})
        return wrap(node)
    v = _small_array(vec).reshape(-1)
    if v.shape[0] != x.ncol:
        raise ValueError(f"mapply.row vector length {v.shape[0]} != ncol {x.ncol}")
    dt = dtypes.promote(x.dtype, v.dtype)
    x = _cast(x, dt)
    node = MapNode("mapply_row", x.shape, f.out_dtype(dt, dt),
                   [x, Small(v.to(dt))], {"vudf": f})
    return wrap(node)


def mapply_col(a: MatLike, vec, f) -> FMMatrix:
    """CC_ij = f(AA_ij, B_i): the vector is long-aligned (length nrow), is
    partitioned alongside the matrix and may itself be virtual."""
    f = _b(f)
    x = as_node(a)
    if isinstance(vec, (FMMatrix, Node)):
        v = as_node(vec)
        if max(v.shape) != x.nrow:
            raise ValueError(
                f"mapply.col vector length {max(v.shape)} != nrow {x.nrow}")
        xx, vv, dt = _promote2(x, v)
        node = MapNode("mapply_col", x.shape, f.out_dtype(dt, dt), [xx, vv],
                       {"vudf": f})
        return wrap(node)
    v = _small_array(vec).reshape(-1)
    if v.shape[0] != x.nrow:
        raise ValueError(f"mapply.col vector length {v.shape[0]} != nrow {x.nrow}")
    leaf = LeafNode(FMMatrix.from_array(v))
    return mapply_col(a, wrap(leaf), f)


def cbind(*mats: MatLike) -> FMMatrix:
    """Virtual column-bind of long-aligned matrices (row-local, fusable)."""
    nodes = [as_node(m) for m in mats]
    n = nodes[0].nrow
    if any(x.nrow != n for x in nodes):
        raise ValueError("cbind: row-count mismatch")
    dt = nodes[0].dtype
    for x in nodes[1:]:
        dt = dtypes.promote(dt, x.dtype)
    nodes = [_cast(x, dt) for x in nodes]
    ncol = sum(x.ncol for x in nodes)
    return wrap(MapNode("cbind", (n, ncol), dt, nodes, {}))


# ---------------------------------------------------------------------------
# aggregation family
# ---------------------------------------------------------------------------

def agg(mat: MatLike, f) -> FMMatrix:
    """c = f-reduce over all elements (sink)."""
    return wrap(AggFullNode(as_node(mat), _a(f)))


def agg_row(mat: MatLike, f) -> FMMatrix:
    """C_i = f-reduce over row i: keeps the long dimension (row-local)."""
    f = _a(f)
    x = as_node(mat)
    node = MapNode("agg_row", (x.nrow, 1), f.out_dtype(x.dtype), [x],
                   {"vudf": f}, name=f"agg.row[{f.name}]")
    return wrap(node)


def agg_col(mat: MatLike, f) -> FMMatrix:
    """C_j = f-reduce over column j: contracts the long dimension (sink)."""
    return wrap(AggColNode(as_node(mat), _a(f)))


# ---------------------------------------------------------------------------
# groupby family
# ---------------------------------------------------------------------------

def groupby_row(mat: MatLike, labels: MatLike, f, num_groups: int) -> FMMatrix:
    """CC_{k,j} = f-reduce over rows i with labels_i == k (sink)."""
    f = _a(f)
    x = as_node(mat)
    lab = as_node(labels) if isinstance(labels, (FMMatrix, Node)) else \
        LeafNode(FMMatrix.from_array(_small_array(labels).reshape(-1)))
    return wrap(GroupByRowNode(x, lab, f, int(num_groups)))


def groupby_col(mat: MatLike, labels, f, num_groups: int) -> FMMatrix:
    """CC_{i,k} = f-reduce over columns j with labels_j == k (row-local)."""
    f = _a(f)
    x = as_node(mat)
    lab = _small_array(labels).reshape(-1)
    if lab.shape[0] != x.ncol:
        raise ValueError("groupby.col labels must have length ncol")
    node = MapNode("groupby_col", (x.nrow, int(num_groups)),
                   f.out_dtype(x.dtype), [x, Small(lab)],
                   {"vudf": f, "num_groups": int(num_groups)})
    return wrap(node)


# ---------------------------------------------------------------------------
# inner product
# ---------------------------------------------------------------------------

def inner_prod(a: MatLike, b, f1="mul", f2="sum") -> FMMatrix:
    """Generalized matrix multiplication: t = f1(A_ik, B_kj); C_ij = f2_k t.
    tall·small is row-local; ``t(X) %*% Y`` contracts the long dimension."""
    f1, f2 = _b(f1), _a(f2)

    a_is_fm = isinstance(a, (FMMatrix, Node))
    a_t = a.transposed_of if isinstance(a, FMMatrix) else None

    if a_is_fm and a_t is not None:
        left = as_node(a_t)
        if isinstance(b, (FMMatrix, Node)):
            right = as_node(b)
        else:
            right = LeafNode(FMMatrix.from_array(_small_array(b)))
        if left.nrow != right.nrow:
            raise ValueError(
                f"inner.prod contraction mismatch: {left.shape} x {right.shape}")
        lft, rgt, _ = _promote2(left, right)
        return wrap(InnerProdContractNode(lft, rgt, f1, f2))

    x = as_node(a)
    b_arr = _small_array(b)
    if b_arr.ndim == 1:
        b_arr = b_arr.reshape(-1, 1)
    if x.ncol != b_arr.shape[0]:
        raise ValueError(f"inner.prod shape mismatch: {x.shape} x {tuple(b_arr.shape)}")
    dt = dtypes.promote(x.dtype, b_arr.dtype)
    out_dt = f2.out_dtype(f1.out_dtype(dt, dt))
    x = _cast(x, dt)
    node = MapNode("matmul_small", (x.nrow, b_arr.shape[1]), out_dt,
                   [x, Small(b_arr.to(dt))],
                   {"mul": f1, "add": f2}, name=f"inner[{f1.name},{f2.name}]")
    return wrap(node)


# ---------------------------------------------------------------------------
# epilogue-only linear algebra
# ---------------------------------------------------------------------------

def solve(a: MatLike, b=None) -> FMMatrix:
    """Lazy R ``solve()``: a⁻¹ (b=None) or the solution x of a·x = b, an
    epilogue op evaluated once after the partition-loop merge."""
    x = as_node(a)
    if x.nrow != x.ncol:
        raise ValueError(f"solve needs a square matrix, got {x.shape}")
    if b is None:
        rhs: "Small | Node" = Small(to_device(np.eye(x.nrow, dtype=np.float32)))
        rhs_ncol, rhs_dt = x.nrow, torch.float32
    elif isinstance(b, (FMMatrix, Node)):
        bn = as_node(b)
        if bn.nrow == x.nrow:
            rhs, rhs_ncol, rhs_dt = bn, bn.ncol, bn.dtype
        elif bn.nrow == 1 and bn.ncol == x.nrow:
            rhs, rhs_ncol, rhs_dt = bn, 1, bn.dtype
        else:
            raise ValueError(
                f"solve shape mismatch: {x.shape} vs {bn.shape}")
    else:
        arr = _small_array(b)
        if arr.ndim == 1 or arr.shape[0] != x.nrow:
            arr = arr.reshape(x.nrow, -1)
        rhs = Small(arr)
        rhs_ncol, rhs_dt = arr.shape[1], arr.dtype
    dt = dtypes.to_floating(dtypes.promote(x.dtype, rhs_dt))
    node = MapNode("solve", (x.nrow, rhs_ncol), dt, [x, rhs], {},
                   name="solve")
    return wrap(node)


# ---------------------------------------------------------------------------
# materialization control
# ---------------------------------------------------------------------------

def set_mate_level(mat: FMMatrix, level: str) -> FMMatrix:
    """fm.set.mate.level: ask the next materialization to keep this virtual
    matrix ('device' = the device tier, 'host' = host RAM, 'disk' = spill
    the output write-through into an on-disk matrix, storage/)."""
    if not mat.is_virtual:
        return mat
    if level not in ("device", "host", "disk"):
        raise ValueError(f"bad materialization level {level!r}")
    mat.node.save = level
    return mat
