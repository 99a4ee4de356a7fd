"""The in-memory sparse store (PyTorch port of the in-memory half of
repro.storage.sparse).

``SparseEllStore`` holds one ELL slab — ``cols`` int32 and ``vals``, both
(nrow, kmax) — either as numpy arrays in host RAM (the host tier, what
``fm.one_hot(...)`` builds by default) or as tensors on the engine's device
(``fm.one_hot(..., host=False)``).  ``whole`` mode stages it as a single
``SparseBlock`` and the streaming modes a row range a partition
(``storage.prefetch.stage_block``: a host slab's rows are copied to the
device leaf by leaf); it is never densified on the way.  The CSR ``.fmat``
file and its memory-mapped store (``CsrMmapStore``) come with the disk tier
(ROADMAP A7b).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes
from ..core.matrix import MatrixStore
from ..core.sparse import SparseBlock


class SparseEllStore(MatrixStore):
    """Sparse store over an ELL slab in host RAM (numpy) or on the device
    (tensors)."""

    layout = "row"
    sparse = True

    def __init__(self, cols, vals, ncol: int, *,
                 nnz: int | None = None):
        if cols.shape != vals.shape or cols.ndim != 2:
            raise ValueError(f"ELL cols {tuple(cols.shape)} and vals "
                             f"{tuple(vals.shape)} must be one (n, kmax) shape")
        self.cols = cols
        self.vals = vals
        self.shape = (int(cols.shape[0]), int(ncol))
        self.dtype = dtypes.canon(vals.dtype)
        self.max_row_nnz = max(1, int(cols.shape[1]))
        if nnz is None:
            nnz = int(np.count_nonzero(vals) if self.on_host
                      else torch.count_nonzero(vals))
        self.nnz = int(nnz)

    @property
    def on_host(self) -> bool:
        return isinstance(self.vals, np.ndarray)

    def block(self, start: int, stop: int) -> SparseBlock:
        return SparseBlock(self.cols[start:stop], self.vals[start:stop],
                           self.shape[1])

    def logical(self):
        """Densified copy: the small-tier escape hatch (``fm.as_np``, oracles);
        O(nrow·ncol) memory, never on the streaming path."""
        return self.block(0, self.shape[0]).todense()

    def nbytes(self) -> int:
        return int(self.cols.nbytes) + int(self.vals.nbytes)

    def transposed(self) -> "MatrixStore":
        return _SparseTransposed(self)

    def __repr__(self):
        tier = "host" if self.on_host else self.cols.device
        return (f"SparseEllStore({self.shape[0]}x{self.shape[1]}, "
                f"kmax={self.max_row_nnz}, {tier})")


class _SparseTransposed(MatrixStore):
    """Zero-copy transpose handle over a sparse store: ``crossprod(X)``
    transposes eagerly, but the contraction only ever peels the
    ``transposed_of`` handle back off, so the wide orientation is never
    read; a partition read of it (column slicing) is refused."""

    layout = "col"
    sparse = False  # wide orientation: never a streaming source

    def __init__(self, base: MatrixStore):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])
        self.dtype = base.dtype

    @property
    def on_host(self) -> bool:
        return self.base.on_host

    @property
    def on_disk(self) -> bool:
        return self.base.on_disk

    def block(self, start: int, stop: int):
        raise NotImplementedError(
            "column-sliced reads of a sparse matrix are not supported; the "
            "transpose is consumed lazily (t(X) %*% Y peels it off)")

    def logical(self):
        return self.base.logical().T

    def nbytes(self) -> int:
        return self.base.nbytes()

    def transposed(self) -> MatrixStore:
        return self.base
