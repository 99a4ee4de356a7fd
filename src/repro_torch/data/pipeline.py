"""Matrix ingest: external files → the on-disk matrix format (PyTorch port
of the ingest half of repro.data.pipeline).

`ingest_csv` / `ingest_binary` / `ingest_factor_csv` are the FlashR
``fm.load.dense.matrix`` / ``fm.load.factor.matrix`` workflow: a multi-GB
text or raw-binary table streamed into the ``.fmat`` format of
``storage/format.py`` in bounded chunks, never fully resident in RAM.
`ingest_factor_csv` is the sparse arm: integer factor columns stream
straight into the CSR ``.fmat`` variant as one-hot rows (k ones per row
among Σ num_levels columns) without ever forming the dense design matrix.
Every ingest path removes its partial output file on failure — a malformed
row, a dtype mismatch or a factor-cardinality overflow raises a clear error
and leaves no truncated ``.fmat`` behind.  The files are byte for byte the
reference's.  (The token half of the reference's module — ``DataConfig``,
``TokenSource``, ``DataIterator`` — comes with the LM training slice,
ROADMAP A14.)
"""
from __future__ import annotations

import contextlib
import pathlib
from typing import Sequence, Union

import numpy as np


# ---------------------------------------------------------------------------
# Matrix ingestion: external files → the on-disk matrix format
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_partial_output(*paths):
    """Remove the named output files if the wrapped ingest fails — a bad
    source must never leave a truncated ``.fmat`` that a later
    ``get_dense_matrix`` would happily mmap."""
    try:
        yield
    except BaseException:
        for p in paths:
            pathlib.Path(p).unlink(missing_ok=True)
        raise


def ingest_csv(src, dest, *, dtype=np.float32, delimiter: str = ",",
               skip_header: int = 0, chunk_rows: int = 65536,
               layout: str = "row") -> "storage_format.MatrixHeader":
    """Stream a numeric CSV/TSV into an on-disk matrix (.fmat).

    One pass, bounded memory: ``chunk_rows`` lines are parsed and appended
    at a time, and the header (which records the final row count) is
    rewritten in place at the end — so Criteo-scale tables ingest without a
    row-counting pre-pass or a full in-RAM copy.
    """
    from ..storage import format as storage_format

    if layout == "col":
        raise NotImplementedError(
            "streaming CSV ingest writes row layout; use fm.conv_layout "
            "afterwards for col-major")
    dest = pathlib.Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.dtype(dtype)
    ncol = None
    nrow = 0
    with _no_partial_output(dest):
        with open(src, "r") as fin, open(dest, "wb") as fout:
            for _ in range(skip_header):
                fin.readline()
            # Reserve the header block; final shape is known only at EOF.
            fout.write(b"\x00" * storage_format.HEADER_BYTES)
            while True:
                lines = []
                for line in fin:
                    if line.strip():
                        lines.append(line)
                    if len(lines) >= chunk_rows:
                        break
                if not lines:
                    break
                try:
                    chunk = np.loadtxt(lines, dtype=dtype,
                                       delimiter=delimiter, ndmin=2)
                except ValueError as e:
                    raise ValueError(
                        f"{src}: malformed CSV in rows "
                        f"[{nrow}, {nrow + len(lines)}): {e}") from None
                if ncol is None:
                    ncol = chunk.shape[1]
                elif chunk.shape[1] != ncol:
                    raise ValueError(
                        f"{src}: ragged CSV — row {nrow} has "
                        f"{chunk.shape[1]} columns, expected {ncol}")
                fout.write(np.ascontiguousarray(chunk))
                nrow += chunk.shape[0]
        if ncol is None:
            raise ValueError(f"{src}: no data rows")
        header = storage_format.MatrixHeader(nrow=nrow, ncol=ncol,
                                             dtype=dtype, layout="row")
        storage_format.write_header(dest, header)
    return header


def ingest_binary(src, dest, *, ncol: int, dtype=np.float32,
                  chunk_rows: int = 65536,
                  layout: str = "row") -> "storage_format.MatrixHeader":
    """Stream a raw row-major binary file (the FlashR
    ``fm.load.dense.matrix`` input: Criteo's preprocessed binaries) into an
    on-disk matrix.  Row count is derived from the file size."""
    from ..storage import format as storage_format

    src = pathlib.Path(src)
    dtype = np.dtype(dtype)
    row_bytes = ncol * dtype.itemsize
    total = src.stat().st_size
    if total % row_bytes:
        raise ValueError(
            f"{src}: size {total} is not a whole number of {ncol}-column "
            f"{dtype.name} rows")
    nrow = total // row_bytes
    if layout != "row":
        raise NotImplementedError("binary ingest writes row layout")
    header = storage_format.MatrixHeader(nrow=nrow, ncol=ncol, dtype=dtype,
                                         layout="row")
    dest = pathlib.Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    with _no_partial_output(dest):
        with open(src, "rb") as fin, open(dest, "wb") as fout:
            fout.write(header.to_bytes())
            while True:
                buf = fin.read(chunk_rows * row_bytes)
                if not buf:
                    break
                fout.write(buf)
    return header


def ingest_factor_csv(src, dest, *, num_levels: Union[int, Sequence[int]],
                      dtype=np.float32, delimiter: str = ",",
                      skip_header: int = 0,
                      chunk_rows: int = 65536) -> dict:
    """Stream a CSV of integer factor columns into a CSR ``.fmat``
    (the Criteo ingest: k hashed-categorical columns → one-hot rows of
    exactly k ones among Σ ``num_levels`` columns) — one pass, bounded
    memory, never forming the dense design matrix.

    ``num_levels`` is the per-column level count (an int applies to every
    column).  Codes must be integers in ``[0, num_levels[j])``; a
    malformed row, a non-integer value or a cardinality overflow raises a
    clear error and removes the partial output.  Returns the CSR header
    meta dict.

    Layout note: the CSR sections are sequential (indptr | indices |
    data), and the section offsets depend on nnz = k·nrow, known only at
    EOF — so column indices stream to a sidecar temp file and the final
    ``.fmat`` is assembled from it in bounded chunks.  With a constant k
    per row, indptr is just ``arange(nrow+1)·k`` and data is all ones;
    neither needs a temp file.
    """
    from ..storage import sparse as storage_sparse

    dest = pathlib.Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".indices.tmp")
    levels = None      # per-column level counts, resolved on first chunk
    offsets = None     # running column offsets of each factor column
    nrow = 0
    with _no_partial_output(dest, tmp):
        with open(src, "r") as fin, open(tmp, "wb") as ftmp:
            for _ in range(skip_header):
                fin.readline()
            while True:
                lines = []
                for line in fin:
                    if line.strip():
                        lines.append(line)
                    if len(lines) >= chunk_rows:
                        break
                if not lines:
                    break
                try:
                    chunk = np.loadtxt(lines, dtype=np.int64,
                                       delimiter=delimiter, ndmin=2)
                except ValueError as e:
                    raise ValueError(
                        f"{src}: malformed factor CSV in rows "
                        f"[{nrow}, {nrow + len(lines)}): {e} (factor "
                        f"columns must be integer codes)") from None
                if levels is None:
                    k = chunk.shape[1]
                    levels = ([int(num_levels)] * k
                              if np.isscalar(num_levels)
                              else [int(v) for v in num_levels])
                    if len(levels) != k:
                        raise ValueError(
                            f"{src}: {k} factor columns but "
                            f"{len(levels)} num_levels entries")
                    offsets = np.cumsum([0] + levels[:-1], dtype=np.int64)
                elif chunk.shape[1] != len(levels):
                    raise ValueError(
                        f"{src}: ragged CSV — row {nrow} has "
                        f"{chunk.shape[1]} columns, expected {len(levels)}")
                if chunk.size and chunk.min() < 0:
                    raise ValueError(
                        f"{src}: negative factor code in rows "
                        f"[{nrow}, {nrow + chunk.shape[0]})")
                over = chunk.max(axis=0) - np.asarray(levels)
                if (over >= 0).any():
                    j = int(np.argmax(over))
                    raise ValueError(
                        f"{src}: factor cardinality overflow — column {j} "
                        f"has code {int(chunk[:, j].max())} but "
                        f"num_levels[{j}]={levels[j]} (codes must be in "
                        f"[0, num_levels))")
                ftmp.write(np.ascontiguousarray(
                    (chunk + offsets).astype(np.int32)))
                nrow += chunk.shape[0]
        if levels is None:
            raise ValueError(f"{src}: no data rows")
        # Assemble the .fmat: header | indptr | indices (from tmp) | ones.
        k = len(levels)
        ncol = int(sum(levels))
        nnz = nrow * k
        dtype = np.dtype(dtype)
        with open(dest, "wb") as fout:
            fout.write(storage_sparse._csr_header_bytes(
                nrow=nrow, ncol=ncol, dtype=dtype, nnz=nnz, max_row_nnz=k))
            indptr_chunk = 1 << 20
            for start in range(0, nrow + 1, indptr_chunk):
                stop = min(start + indptr_chunk, nrow + 1)
                fout.write(np.arange(start, stop, dtype=np.int64) * k)
            with open(tmp, "rb") as ftmp:
                while True:
                    buf = ftmp.read(chunk_rows * k * 4)
                    if not buf:
                        break
                    fout.write(buf)
            ones = np.ones(min(nnz, chunk_rows * k), dtype)
            written = 0
            while written < nnz:
                n = min(nnz - written, ones.shape[0])
                fout.write(ones[:n])
                written += n
    tmp.unlink(missing_ok=True)
    return storage_sparse.read_csr_meta(dest)
