"""Training tokens and matrix ingest (PyTorch port of
repro.data.pipeline).

The token half: ``TokenSource`` is a flat token stream on the slow tier —
the synthetic Zipf(1.3) corpus drawn from ``np.random.default_rng(seed)``,
or ``.npy`` / raw uint16 shards, memory-mapped — and ``DataIterator`` cuts
it into the reference's windows (``_host_batch``: rows of seq_len + 1
tokens, tokens and labels shifted by one, a process's rows disjoint from
the others') with one batch staged ahead: on a CUDA device, batch N + 1
is cut, pinned and queued as a non-blocking copy before step N runs.  That
hides the host's window and pinning time; the copy itself is queued on the
current stream, so on the card it runs after step N's work, not beside
it (a batch is a few tens of KB).  The
iterator's state is one step cursor (``state_dict`` / ``load_state_dict``)
that round-trips through checkpoints.  The windows are the reference's bit
for bit.

The matrix half: `ingest_csv` / `ingest_binary` / `ingest_factor_csv` are
the FlashR ``fm.load.dense.matrix`` / ``fm.load.factor.matrix`` workflow: a
multi-GB text or raw-binary table streamed into the ``.fmat`` format of
``storage/format.py`` in bounded chunks, never fully resident in RAM.
`ingest_factor_csv` is the sparse arm: integer factor columns stream
straight into the CSR ``.fmat`` variant as one-hot rows (k ones per row
among Σ num_levels columns) without ever forming the dense design matrix.
Every ingest path removes its partial output file on failure — a malformed
row, a dtype mismatch or a factor-cardinality overflow raises a clear error
and leaves no truncated ``.fmat`` behind.  The files are byte for byte the
reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab: int = 32000
    seed: int = 0
    shards: Optional[Sequence[str]] = None   # token files; None => synthetic
    synthetic_tokens: int = 1 << 22          # per synthetic "shard"


class TokenSource:
    """A flat token stream on the slow tier."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.shards:
            self._arrays = [np.load(p, mmap_mode="r") if str(p).endswith(".npy")
                            else np.memmap(p, dtype=np.uint16, mode="r")
                            for p in cfg.shards]
        else:
            rng = np.random.default_rng(cfg.seed)
            # Zipf-ish synthetic corpus: realistic token frequency skew.
            ranks = rng.zipf(1.3, size=cfg.synthetic_tokens)
            self._arrays = [np.minimum(ranks, cfg.vocab - 1).astype(np.int32)]
        self.total = sum(a.shape[0] for a in self._arrays)

    def window(self, start: int, length: int) -> np.ndarray:
        """Contiguous token window with wraparound (one I/O-level read)."""
        start = start % self.total
        out = np.empty(length, np.int32)
        filled = 0
        offset = start
        for _ in self._arrays * 2:  # wraps at most once
            if filled == length:
                break
            lo = offset % self.total
            # locate shard-local offset
            acc = 0
            for arr in self._arrays:
                if lo < acc + arr.shape[0]:
                    local = lo - acc
                    take = min(length - filled, arr.shape[0] - local)
                    out[filled:filled + take] = arr[local:local + take]
                    filled += take
                    offset += take
                    break
                acc += arr.shape[0]
        return out


class DataIterator:
    """Deterministic, resumable batch iterator staging one batch ahead on
    ``device`` (None: the engine's device) — or, given ``sharding`` (a
    dict of ``NamedSharding``, one per input, as ``sharding_for("batch|seq",
    ...)`` gives them), laid out on its mesh: each batch a dict of
    ``ShardedTensor``, each position holding its rows, staged through the
    mesh's first device."""

    def __init__(self, cfg: DataConfig, *, sharding=None, device=None,
                 process_index: int = 0, process_count: int = 1):
        if sharding is not None:
            first = next(iter(sharding.values()))
            device = first.device(first.positions()[0])
        if device is None:
            from ..storage import registry  # deferred: registry imports core
            device = registry.device()
        self.cfg = cfg
        self.sharding = sharding
        self.source = TokenSource(cfg)
        self.step = 0
        self.device = torch.device(device)
        self.process_index = process_index
        self.process_count = process_count
        self._staged = None  # the batch staged ahead

    # -- fault-tolerance contract -------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict):
        self.step = int(state["step"])
        self._staged = None

    # -- batch construction ----------------------------------------------------
    def _host_batch(self, step: int) -> dict:
        cfg = self.cfg
        per_proc = cfg.global_batch // self.process_count
        span = cfg.seq_len + 1
        base = (step * cfg.global_batch + self.process_index * per_proc) * span
        toks = np.stack([
            self.source.window(base + i * span, span) for i in range(per_proc)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _stage(self, batch_np: dict) -> dict:
        """Host → device: from pinned memory without blocking on a card."""
        out = {}
        for k, v in batch_np.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        if self.sharding is not None:
            from ..distributed.sharding import place
            out = {k: place(v, self.sharding[k]) for k, v in out.items()}
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._staged is None:
            self._staged = self._stage(self._host_batch(self.step))
        out = self._staged
        self.step += 1
        # stage the next batch while the caller computes on `out`
        self._staged = self._stage(self._host_batch(self.step))
        return out


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
