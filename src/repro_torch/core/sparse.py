"""Sparse row blocks (the one-hot tier's in-flight representation), PyTorch
port of repro.core.sparse.

FlashR's flagship sparse workload — logistic regression over the one-hot
Criteo set (``fm.as.factor`` on 26 hash columns) — has a few ones per row
among thousands of columns; storing it dense wastes orders of magnitude of
bandwidth.  What flows through the engine is a ``SparseBlock``: a
fixed-width ELL slab —

    cols  int32  (rows, kmax)     column index of each stored element
    vals  dtype  (rows, kmax)     the element values
    ncol  int                     the logical column count

padded per row with (col=0, val=0) entries, which are neutral for every
implicit-zero GenOp (sum-product contraction, colsum scatter, gather matmul).
In ``whole`` mode on the device tier the whole slab is one block.  It is a
plain class: PyTorch needs no pytree registration.  The construction helpers
at the bottom are host-side numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes


class SparseBlock:
    """One partition of a sparse matrix in ELL layout."""

    __slots__ = ("cols", "vals", "ncol")

    def __init__(self, cols, vals, ncol: int):
        self.cols = cols
        self.vals = vals
        self.ncol = int(ncol)

    @property
    def shape(self) -> tuple:
        return (int(self.cols.shape[0]), self.ncol)

    @property
    def kmax(self) -> int:
        return int(self.cols.shape[1])

    @property
    def dtype(self):
        return dtypes.canon(self.vals.dtype)

    @property
    def nbytes(self) -> int:
        return int(self.cols.nbytes) + int(self.vals.nbytes)

    @property
    def ndim(self) -> int:
        return 2

    def __repr__(self):
        return (f"SparseBlock({self.shape[0]}x{self.ncol}, "
                f"kmax={self.kmax}, {dtypes.name(self.dtype)})")

    def todense(self):
        """Expand to a dense (rows, ncol) array: numpy in → numpy out,
        tensor in → tensor out.  Padding entries are (col=0, val=0), so a
        scatter-ADD is safe: a zero lands anywhere and adds nothing."""
        rows, kmax = self.cols.shape
        if isinstance(self.vals, np.ndarray):
            out = np.zeros((rows, self.ncol), self.vals.dtype)
            r = np.repeat(np.arange(rows), kmax)
            np.add.at(out, (r, np.asarray(self.cols).reshape(-1)),
                      np.asarray(self.vals).reshape(-1))
            return out
        out = torch.zeros((rows, self.ncol), dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.scatter_add_(1, self.cols.to(torch.int64), self.vals)

    def matmul_small(self, small, out_dtype=None, chunk_elems: int = 1 << 26):
        """X @ B for a small dense B (ncol, q) WITHOUT densifying X: a gather
        of B's rows and a kmax-reduction, out[i, j] = Σ_k vals[i, k] ·
        B[cols[i, k], j] — nnz-proportional work (eta = X @ beta).  Evaluated
        in row chunks so the (rows, kmax, q) gather stays under
        ``chunk_elems`` elements."""
        acc = torch.float32 if self.vals.dtype == torch.bfloat16 \
            else self.vals.dtype
        rows, kmax = self.cols.shape
        q = small.shape[1]
        step = max(1, chunk_elems // max(1, kmax * q))
        outs = []
        for s in range(0, max(rows, 1), step):
            e = min(rows, s + step)
            g = small[self.cols[s:e].to(torch.int64)]         # (r, kmax, q)
            outs.append((self.vals[s:e, :, None].to(acc) * g.to(acc)).sum(1))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        return out.to(out_dtype) if out_dtype is not None else out


def is_sparse(x) -> bool:
    return isinstance(x, SparseBlock)


def is_sparse_mat(mat) -> bool:
    """True for a physical FMMatrix whose store serves SparseBlocks."""
    store = getattr(mat, "store", None)
    return bool(store is not None and getattr(store, "sparse", False))


def effective_ncol(mat) -> int:
    """The streaming width a partition planner budgets for: a sparse source
    moves 2·kmax scalars per row (cols + vals), not ncol."""
    store = getattr(mat, "store", None)
    if store is not None and getattr(store, "sparse", False):
        return max(1, 2 * int(store.max_row_nnz))
    return mat.ncol


# ---------------------------------------------------------------------------
# Construction helpers (host-side numpy)
# ---------------------------------------------------------------------------

def ell_from_csr_rows(indptr, indices, data, start: int, stop: int,
                      kmax: int, ncol: int) -> SparseBlock:
    """Slice CSR rows [start, stop) into an ELL SparseBlock (numpy).  When
    every row holds kmax entries (a one-hot design: k ones a row) the ELL
    slab is the CSR sections themselves, copied in one read each; other
    rows are scattered to their slots, padding left (col=0, val=0)."""
    rows = stop - start
    rs, re = int(indptr[start]), int(indptr[stop])
    if re - rs == rows * kmax:
        # all rows full (no row exceeds kmax): one contiguous copy a leaf
        return SparseBlock(
            np.array(indices[rs:re], np.int32).reshape(rows, kmax),
            np.array(data[rs:re]).reshape(rows, kmax), ncol)
    counts = np.diff(indptr[start:stop + 1]).astype(np.int64)
    cols = np.zeros((rows, kmax), np.int32)
    vals = np.zeros((rows, kmax), data.dtype)
    if re > rs:
        # flat slot of entry e of row r: r·kmax + (e − the row's first)
        slot = np.arange(re - rs) + np.repeat(
            np.arange(rows, dtype=np.int64) * kmax - (indptr[start:stop] - rs),
            counts)
        cols.reshape(-1)[slot] = indices[rs:re]
        vals.reshape(-1)[slot] = data[rs:re]
    return SparseBlock(cols, vals, ncol)


def csr_from_dense(arr):
    """Dense (n, p) numpy array → (indptr, indices, data) CSR triplet."""
    arr = np.asarray(arr)
    mask = arr != 0
    counts = mask.sum(axis=1)
    indptr = np.zeros(arr.shape[0] + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    r, c = np.nonzero(mask)
    return indptr, c.astype(np.int32), np.ascontiguousarray(arr[r, c])


def csr_from_ell(cols, vals):
    """ELL slab → CSR triplet, dropping the (col=0, val=0) padding; entries
    stay grouped by row in within-row ELL order."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    mask = vals != 0
    if mask.all():
        # no padding (a one-hot design): the sections are the slab's rows
        indptr = np.arange(cols.shape[0] + 1, dtype=np.int64) * cols.shape[1]
        return (indptr, np.ascontiguousarray(cols, np.int32).reshape(-1),
                np.ascontiguousarray(vals).reshape(-1))
    counts = mask.sum(axis=1)
    indptr = np.zeros(cols.shape[0] + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[mask].astype(np.int32), np.ascontiguousarray(
        vals[mask])
