"""On-disk single-file matrix format (the FlashR external-memory matrix),
PyTorch port of repro.storage.format: the same bytes, so a file either
package writes, the other reads.

Layout of a ``.fmat`` file:

    [0, 8)              magic  b"FMATRIX1"
    [8, 12)             u32 little-endian format version (currently 1)
    [12, 16)            u32 little-endian length of the JSON header
    [16, 16+json_len)   JSON header: nrow, ncol, dtype (numpy ``.str``,
                        endianness-explicit), layout ('row'|'col'),
                        body_offset, row_align
    [.., HEADER_BYTES)  zero padding
    [HEADER_BYTES, ..)  body: the stored buffer, C-contiguous — shape
                        (nrow, ncol) for 'row' layout, (ncol, nrow) for
                        'col' (the zero-copy-transpose convention of
                        core.matrix.MatrixStore)

The body starts at a page-aligned offset (HEADER_BYTES = 4096), so a
partition read of rows [start, stop) of a 'row' file is one contiguous,
page-aligned range of the file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Union

import numpy as np
import torch

MAGIC = b"FMATRIX1"
VERSION = 1
HEADER_BYTES = 4096

PathLike = Union[str, os.PathLike]


@dataclasses.dataclass(frozen=True)
class MatrixHeader:
    """Parsed header of an on-disk matrix."""

    nrow: int
    ncol: int
    dtype: np.dtype        # element dtype (endianness-explicit on disk)
    layout: str            # 'row' | 'col'
    body_offset: int = HEADER_BYTES
    row_align: int = 8     # core.matrix.ROW_ALIGN at write time

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrow, self.ncol)

    @property
    def stored_shape(self) -> tuple[int, int]:
        """Shape of the buffer as laid out in the file."""
        if self.layout == "col":
            return (self.ncol, self.nrow)
        return (self.nrow, self.ncol)

    def body_nbytes(self) -> int:
        return self.nrow * self.ncol * self.dtype.itemsize

    def to_bytes(self) -> bytes:
        payload = json.dumps({
            "nrow": self.nrow, "ncol": self.ncol,
            "dtype": np.dtype(self.dtype).str, "layout": self.layout,
            "body_offset": self.body_offset, "row_align": self.row_align,
        }).encode()
        head = (MAGIC + VERSION.to_bytes(4, "little")
                + len(payload).to_bytes(4, "little") + payload)
        if len(head) > self.body_offset:
            raise ValueError("header does not fit the reserved block")
        return head + b"\x00" * (self.body_offset - len(head))


def _read_meta(path: PathLike) -> dict:
    with open(path, "rb") as f:
        fixed = f.read(16)
        if len(fixed) < 16 or fixed[:8] != MAGIC:
            raise ValueError(f"{path}: not an fmat file (bad magic)")
        version = int.from_bytes(fixed[8:12], "little")
        if version > VERSION:
            raise ValueError(f"{path}: fmat version {version} > {VERSION}")
        json_len = int.from_bytes(fixed[12:16], "little")
        return json.loads(f.read(json_len).decode())


def read_header(path: PathLike) -> MatrixHeader:
    meta = _read_meta(path)
    if meta.get("format", "dense") != "dense":
        raise ValueError(
            f"{path}: a {meta['format']!r} fmat file, not dense — open it "
            f"through storage.open_matrix (which dispatches on the format) "
            f"or storage.sparse.open_csr")
    if meta["layout"] not in ("row", "col"):
        raise ValueError(f"{path}: bad layout {meta['layout']!r}")
    return MatrixHeader(
        nrow=int(meta["nrow"]), ncol=int(meta["ncol"]),
        dtype=np.dtype(meta["dtype"]), layout=meta["layout"],
        body_offset=int(meta.get("body_offset", HEADER_BYTES)),
        row_align=int(meta.get("row_align", 8)))


def write_header(path: PathLike, header: MatrixHeader):
    """(Re)write the fixed-size header block in place — used by streaming
    ingest that learns the final nrow only after the body is written."""
    with open(path, "r+b") as f:
        f.write(header.to_bytes())


# ---------------------------------------------------------------------------
# Whole-matrix save / open / preallocate
# ---------------------------------------------------------------------------

def _host(chunk) -> np.ndarray:
    """A chunk as a C-contiguous numpy array: a tensor (on any device) is
    copied to host RAM, bf16 as float32 — its host staging type, which
    numpy can name (the reference writes ml_dtypes' bfloat16 as '<V2',
    which neither package reads back as a matrix; ROADMAP §C)."""
    if isinstance(chunk, torch.Tensor):
        t = chunk.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().contiguous().numpy()
    return np.ascontiguousarray(chunk)


def save_matrix(path: PathLike, arr, *, layout: str = "row",
                chunk_rows: int = 65536) -> MatrixHeader:
    """Write a matrix (numpy array, tensor, or physical FMMatrix) to
    ``path``.

    The body streams out in ``chunk_rows`` slabs, so neither a host array
    nor a tensor on the card ever needs a second full-size copy in host
    RAM; 1-D arrays become one-column matrices (the engine-wide vector
    convention)."""
    if layout not in ("row", "col"):
        raise ValueError(f"bad layout {layout!r}")
    if hasattr(arr, "logical_data"):          # FMMatrix duck-type
        arr = arr.logical_data()
    if isinstance(arr, torch.Tensor):
        dtype = np.dtype(np.float32) if arr.dtype == torch.bfloat16 \
            else torch.empty((), dtype=arr.dtype).numpy().dtype
    else:
        arr = np.asarray(arr)
        dtype = np.dtype(arr.dtype)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise ValueError(f"expected a matrix, got ndim={arr.ndim}")
    header = MatrixHeader(nrow=int(arr.shape[0]), ncol=int(arr.shape[1]),
                          dtype=dtype, layout=layout)
    stored = arr.T if layout == "col" else arr
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.to_bytes())
        for start in range(0, stored.shape[0], chunk_rows):
            f.write(_host(stored[start:start + chunk_rows]))
    return header


def peek_format(path: PathLike) -> str:
    """The container variant of an ``.fmat`` file: 'dense' or 'csr'.
    Reads only the header block."""
    with open(path, "rb") as f:
        fixed = f.read(16)
        if len(fixed) < 16 or fixed[:8] != MAGIC:
            raise ValueError(f"{path}: not an fmat file (bad magic)")
        json_len = int.from_bytes(fixed[12:16], "little")
        meta = json.loads(f.read(json_len).decode())
    return meta.get("format", "dense")


def open_matrix(path: PathLike, *, mode: str = "r"):
    """Open an on-disk matrix (no data is read): an ``MmapStore`` for the
    dense format, a ``CsrMmapStore`` for the sparse CSR variant."""
    from .store import MmapStore
    if peek_format(path) == "csr":
        from .sparse import open_csr
        return open_csr(path)
    return MmapStore(path, read_header(path), mode=mode)


def create_matrix(path: PathLike, shape, dtype, *, layout: str = "row"):
    """Preallocate an on-disk matrix and return a *writable* ``MmapStore``
    — the spill target for ``save='disk'`` outputs (write-through)."""
    from .store import MmapStore
    header = MatrixHeader(nrow=int(shape[0]), ncol=int(shape[1]),
                          dtype=np.dtype(dtype), layout=layout)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.to_bytes())
        f.truncate(header.body_offset + header.body_nbytes())
    return MmapStore(path, header, mode="r+")
