"""Sparse stores: the CSR variant of the on-disk ``.fmat`` format (the
Criteo tier) and the in-memory ELL slab (PyTorch port of
repro.storage.sparse; the file's bytes are the reference's).

A CSR ``.fmat`` is the container of ``format.py`` — magic, version,
page-aligned JSON header block — with ``"format": "csr"`` in the header and
three body sections instead of one dense buffer:

    [HEADER_BYTES, ..)     indptr   int64  (nrow + 1)
    [indices_offset, ..)   indices  int32  (nnz)
    [data_offset, ..)      data     dtype  (nnz)

``indptr`` maps in O(1); a partition read of rows [start, stop) is two
contiguous range reads (indices + data) located by the indptr slice.  The
header also records ``max_row_nnz``, the widest row: ``CsrMmapStore``
expands every partition to a fixed (rows, max_row_nnz) ELL ``SparseBlock``
of numpy leaves, which ``storage.prefetch.stage_block`` stages as it stages
a host slab's block.

``SparseEllStore`` holds one ELL slab — ``cols`` int32 and ``vals``, both
(nrow, kmax) — either as numpy arrays in host RAM (the host tier, what
``fm.one_hot(...)`` builds by default) or as tensors on the engine's device
(``fm.one_hot(..., host=False)``).  ``whole`` mode stages it as a single
``SparseBlock`` and the streaming modes a row range a partition
(``storage.prefetch.stage_block``: a host slab's rows are copied to the
device leaf by leaf); it is never densified on the way.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..core import dtypes
from ..core.matrix import MatrixStore
from ..core.sparse import SparseBlock, ell_from_csr_rows
from .format import HEADER_BYTES, MAGIC, VERSION, PathLike


def _csr_header_bytes(*, nrow: int, ncol: int, dtype, nnz: int,
                      max_row_nnz: int) -> bytes:
    indptr_offset = HEADER_BYTES
    indices_offset = indptr_offset + (nrow + 1) * 8
    data_offset = indices_offset + nnz * 4
    payload = json.dumps({
        "format": "csr", "nrow": int(nrow), "ncol": int(ncol),
        "dtype": np.dtype(dtype).str, "layout": "row",
        "nnz": int(nnz), "max_row_nnz": int(max_row_nnz),
        "indptr_offset": indptr_offset, "indices_offset": indices_offset,
        "data_offset": data_offset,
    }).encode()
    head = (MAGIC + VERSION.to_bytes(4, "little")
            + len(payload).to_bytes(4, "little") + payload)
    if len(head) > HEADER_BYTES:
        raise ValueError("csr header does not fit the reserved block")
    return head + b"\x00" * (HEADER_BYTES - len(head))


def read_csr_meta(path: PathLike) -> dict:
    with open(path, "rb") as f:
        fixed = f.read(16)
        if len(fixed) < 16 or fixed[:8] != MAGIC:
            raise ValueError(f"{path}: not an fmat file (bad magic)")
        json_len = int.from_bytes(fixed[12:16], "little")
        meta = json.loads(f.read(json_len).decode())
    if meta.get("format") != "csr":
        raise ValueError(f"{path}: not a csr fmat file")
    return meta


def save_csr_matrix(path: PathLike, indptr, indices, data, *,
                    ncol: int) -> dict:
    """Write a CSR triplet to ``path``; returns the header meta dict."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data)
    nrow = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    if indices.shape[0] != nnz or data.shape[0] != nnz:
        raise ValueError(
            f"CSR sections disagree: indptr says nnz={nnz}, have "
            f"{indices.shape[0]} indices / {data.shape[0]} values")
    if nnz and (indices.min() < 0 or indices.max() >= ncol):
        raise ValueError(f"CSR column index out of range for ncol={ncol}")
    max_row_nnz = int(np.diff(indptr).max()) if nrow else 0
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_csr_header_bytes(nrow=nrow, ncol=ncol, dtype=data.dtype,
                                  nnz=nnz, max_row_nnz=max_row_nnz))
        f.write(indptr.tobytes())
        f.write(indices.tobytes())
        f.write(data.tobytes())
    return read_csr_meta(path)


def open_csr(path: PathLike) -> "CsrMmapStore":
    return CsrMmapStore(path, read_csr_meta(path))


class CsrMmapStore(MatrixStore):
    """Disk-backed CSR matrix store: ``block()`` returns ELL SparseBlocks
    of numpy leaves."""

    layout = "row"
    sparse = True

    def __init__(self, path, meta: dict):
        self.path = pathlib.Path(path)
        self.meta = meta
        self.shape = (int(meta["nrow"]), int(meta["ncol"]))
        file_dtype = np.dtype(meta["dtype"])
        self.dtype = dtypes.canon(file_dtype)
        self.nnz = int(meta["nnz"])
        # kmax floor of 1 keeps the all-zero-matrix ELL slab a valid shape.
        self.max_row_nnz = max(1, int(meta["max_row_nnz"]))
        self._indptr = np.memmap(self.path, dtype=np.int64, mode="r",
                                 offset=int(meta["indptr_offset"]),
                                 shape=(self.shape[0] + 1,))
        self._indices = np.memmap(self.path, dtype=np.int32, mode="r",
                                  offset=int(meta["indices_offset"]),
                                  shape=(self.nnz,))
        self._data = np.memmap(self.path, dtype=file_dtype, mode="r",
                               offset=int(meta["data_offset"]),
                               shape=(self.nnz,))

    @property
    def on_host(self) -> bool:
        return True

    @property
    def on_disk(self) -> bool:
        return True

    def block(self, start: int, stop: int) -> SparseBlock:
        return ell_from_csr_rows(self._indptr, self._indices, self._data,
                                 start, stop, self.max_row_nnz,
                                 self.shape[1])

    def logical(self) -> np.ndarray:
        """Densified copy — the small-tier escape hatch (``fm.as_np``,
        oracles).  O(nrow·ncol) RAM; the streaming path goes through
        ``block()``."""
        return self.block(0, self.shape[0]).todense()

    def nbytes(self) -> int:
        """Physical bytes on disk (what streaming actually moves) — not
        nrow·ncol·itemsize, and not the ELL slab's bytes either."""
        return ((self.shape[0] + 1) * 8 + self.nnz * 4
                + self.nnz * self._data.dtype.itemsize)

    def transposed(self) -> "MatrixStore":
        return _SparseTransposed(self)

    def __repr__(self):
        return (f"CsrMmapStore({self.shape[0]}x{self.shape[1]}, "
                f"{dtypes.name(self.dtype)}, nnz={self.nnz}, "
                f"kmax={self.max_row_nnz}, path={str(self.path)!r})")


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
