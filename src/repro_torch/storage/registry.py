"""Named-matrix registry + engine configuration (FlashR's EM workflow),
PyTorch port of repro.storage.registry.

FlashR keeps external-memory matrices as named files under a configured
data directory (``fm.set.conf``); users reopen them by name with
``fm.get.dense.matrix`` and create them with ``fm.load.dense.matrix`` /
``fm.persist(x, tier="disk")``:

    fm.set_conf(data_dir="/ssd/fm")            # once per deployment
    X = fm.load_dense_matrix("criteo.csv", name="criteo")   # ingest → disk
    X = fm.get_dense_matrix("criteo")          # O(1) reopen, mmap-backed

The registry is directory-backed (one ``<name>.fmat`` per matrix), so it is
shared between processes — and between this package and ``repro``, whose
files are byte-compatible — and survives restarts.

The knob names are the reference's (``KNOWN_KNOBS``), so one test program
configures both packages, plus ``device``: the ``torch.device`` every
matrix and every accumulator lives on.  It is ``cuda`` unless the caller
asks for the CPU (``fm.set_conf(device="cpu")`` or ``fm.conf(device=
"cpu")``); with no card and no such request, ``device()`` raises rather
than carry on quietly on the CPU.  ``mesh`` comes with the multi-GPU slice
(ROADMAP A13).
"""
from __future__ import annotations

import atexit
import contextlib
import difflib
import itertools
import os
import pathlib
import re
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from ..core import lowering as lowering_mod
from ..core import matrix as matrix_mod
from ..core.matrix import FMMatrix
from . import format as fmt

_CONF = {
    "data_dir": None,       # pathlib.Path once configured / first used
    "prefetch": True,       # default for ooc execution
    "prefetch_depth": 2,    # bounded-queue depth
    "direct_io": False,     # best-effort page-cache bypass on disk reads
    "mesh": None,           # sharded execution (ROADMAP A13)
    "device": "cuda",       # where matrices, partials and results live
}

#: Temp dirs the registry itself mkdtemp'd (never a user-supplied
#: data_dir): removed at interpreter exit and by ``cleanup()``.
_OWNED_DIRS: list[pathlib.Path] = []
_ATEXIT_REGISTERED = False

_spill_ids = itertools.count()

#: Guards _CONF, most importantly the lazy ``data_dir()`` init: two
#: threads racing the first disk-tier touch (concurrent materializes, the
#: prefetcher's worker) must agree on one directory.
_CONF_LOCK = threading.Lock()

#: The full knob table ``set_conf`` validates against.
KNOWN_KNOBS = {
    "data_dir": "storage-tier directory for named .fmat matrices",
    "prefetch": "async partition prefetch default for ooc execution",
    "prefetch_depth": "bounded staging-queue depth (2 = double buffering)",
    "io_partition_bytes": "I/O-level partition budget (streaming granule)",
    "vmem_partition_bytes": "processor-level (tile) partition budget",
    "backend": "lowering backend: 'auto' | 'torch' | 'cuda'",
    "direct_io": "best-effort page-cache bypass on partition reads",
    "mesh": "sharded execution across cards (multi-GPU slice)",
    "device": "torch device of the engine: 'cuda' (default) or 'cpu'",
}


def _check_knobs(kw: dict):
    unknown = [k for k in kw if k not in KNOWN_KNOBS]
    if not unknown:
        return
    parts = []
    for k in unknown:
        close = difflib.get_close_matches(k, KNOWN_KNOBS, n=1)
        parts.append(f"{k!r} (did you mean {close[0]!r}?)" if close
                     else repr(k))
    plural = "s" if len(parts) > 1 else ""
    raise ValueError(
        f"unknown config knob{plural} {', '.join(parts)}; known knobs: "
        f"{', '.join(sorted(KNOWN_KNOBS))}")


def set_conf(**kw) -> dict:
    """fm.set.conf: configure the engine; returns the live config.  ``None``
    means "leave unchanged"; ``fm.conf(...)`` is the scoped override."""
    _check_knobs(kw)
    if kw.get("mesh") not in (None, False):
        raise NotImplementedError(
            "sharded execution across cards comes with the multi-GPU slice "
            "(ROADMAP A13)")
    dev = kw.get("device")
    if dev is not None:
        dev = torch.device(dev)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu'; got {dev}")
    backend = kw.get("backend")
    if backend is not None and backend != "auto" \
            and backend not in lowering_mod.BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; have "
            f"{sorted(lowering_mod.BACKENDS)} + 'auto'")
    if kw.get("data_dir") is not None:
        pathlib.Path(kw["data_dir"]).mkdir(parents=True, exist_ok=True)
    with _CONF_LOCK:
        if kw.get("data_dir") is not None:
            _CONF["data_dir"] = pathlib.Path(kw["data_dir"])
        for k in ("prefetch", "direct_io"):
            if kw.get(k) is not None:
                _CONF[k] = bool(kw[k])
        if kw.get("prefetch_depth") is not None:
            if int(kw["prefetch_depth"]) < 1:
                raise ValueError("prefetch_depth must be >= 1")
            _CONF["prefetch_depth"] = int(kw["prefetch_depth"])
        if dev is not None:
            _CONF["device"] = str(dev)
        if kw.get("io_partition_bytes") is not None:
            matrix_mod.IO_PARTITION_BYTES = int(kw["io_partition_bytes"])
        if kw.get("vmem_partition_bytes") is not None:
            matrix_mod.VMEM_PARTITION_BYTES = int(kw["vmem_partition_bytes"])
        if backend is not None:
            lowering_mod.DEFAULT_BACKEND = backend
        return dict(_CONF, io_partition_bytes=matrix_mod.IO_PARTITION_BYTES,
                    vmem_partition_bytes=matrix_mod.VMEM_PARTITION_BYTES,
                    backend=lowering_mod.DEFAULT_BACKEND)


def get_conf(key: str):
    if key == "io_partition_bytes":
        return matrix_mod.IO_PARTITION_BYTES
    if key == "vmem_partition_bytes":
        return matrix_mod.VMEM_PARTITION_BYTES
    if key == "backend":
        return lowering_mod.DEFAULT_BACKEND
    return _CONF[key]


def _restore_conf(snapshot: dict):
    """Put knobs back exactly as snapshotted (bypasses "None = unchanged")."""
    with _CONF_LOCK:
        for k, v in snapshot.items():
            if k == "io_partition_bytes":
                matrix_mod.IO_PARTITION_BYTES = v
            elif k == "vmem_partition_bytes":
                matrix_mod.VMEM_PARTITION_BYTES = v
            elif k == "backend":
                lowering_mod.DEFAULT_BACKEND = v
            else:
                _CONF[k] = v


@contextlib.contextmanager
def conf(**kw):
    """fm.conf: scoped configuration override; prior values are restored on
    exit, even on error."""
    _check_knobs(kw)
    snapshot = {k: get_conf(k) for k in kw}
    try:
        yield set_conf(**kw)
    finally:
        _restore_conf(snapshot)


def device() -> torch.device:
    """The engine's device.  Raises when it is CUDA and no card is present:
    the port never falls back to the CPU unasked."""
    dev = torch.device(_CONF["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; ask for the CPU with "
            "fm.set_conf(device='cpu') or fm.conf(device='cpu')")
    return dev


# ---------------------------------------------------------------------------
# The data directory
# ---------------------------------------------------------------------------

def data_dir() -> pathlib.Path:
    """The configured data directory (lazily a fresh temp dir, so the disk
    tier works out of the box in tests and examples).  Thread-safe: the
    lazy init is locked so concurrent first touches agree on one dir.
    Lazily-created dirs are registry-owned: they are removed at process
    exit (atexit) or by ``cleanup()``; a user-supplied ``data_dir`` is
    never touched."""
    global _ATEXIT_REGISTERED
    with _CONF_LOCK:
        if _CONF["data_dir"] is None:
            d = pathlib.Path(tempfile.mkdtemp(prefix="fm-data-"))
            _CONF["data_dir"] = d
            _OWNED_DIRS.append(d)
            if not _ATEXIT_REGISTERED:
                atexit.register(cleanup)
                _ATEXIT_REGISTERED = True
        return _CONF["data_dir"]


def cleanup() -> list[pathlib.Path]:
    """Remove every ``fm-data-*`` dir the registry itself created and
    forget them.  User-configured directories are never removed.  Returns
    the removed paths.  Runs automatically at interpreter exit."""
    with _CONF_LOCK:
        owned, _OWNED_DIRS[:] = list(_OWNED_DIRS), []
        for d in owned:
            shutil.rmtree(d, ignore_errors=True)
        if _CONF["data_dir"] in owned:
            _CONF["data_dir"] = None
    return owned


def _sanitize(name: str) -> str:
    clean = re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("._")
    return clean or "matrix"


def matrix_path(name: str) -> pathlib.Path:
    return data_dir() / f"{_sanitize(name)}.fmat"


def spill_path(name: str = "") -> pathlib.Path:
    """A fresh file for a write-through spill output (save='disk')."""
    return (data_dir() / "spill"
            / f"{_sanitize(name or 'out')}-{next(_spill_ids)}.fmat")


# ---------------------------------------------------------------------------
# The EM-matrix surface
# ---------------------------------------------------------------------------

def save_dense_matrix(mat, name: Optional[str] = None, *,
                      layout: str = "row") -> FMMatrix:
    """Write a matrix (FMMatrix, numpy array or tensor) to the data dir
    under ``name`` and return the disk-backed handle."""
    if name is None:
        name = getattr(mat, "name", "") or f"anon-{next(_spill_ids)}"
    fmt.save_matrix(matrix_path(name), mat, layout=layout)
    return get_dense_matrix(name)


def _host_leaf(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_sparse_matrix(mat, name: Optional[str] = None) -> FMMatrix:
    """Write a sparse-tier matrix (a SparseEllStore- or CsrMmapStore-backed
    FMMatrix: host or device slab, or any matrix worth storing sparse) to
    the data dir as a CSR ``.fmat`` and return the disk-backed handle
    (``fm.persist(x, tier='disk')`` routes sparse matrices here); a device
    slab's cols / vals are copied to host RAM first."""
    from ..core.sparse import csr_from_dense, csr_from_ell
    from . import sparse as sp
    if name is None:
        name = getattr(mat, "name", "") or f"anon-{next(_spill_ids)}"
    path = matrix_path(name)
    store = getattr(mat, "store", None)
    if isinstance(store, sp.CsrMmapStore):
        triplet = (np.asarray(store._indptr), np.asarray(store._indices),
                   np.asarray(store._data))
    elif isinstance(store, sp.SparseEllStore):
        triplet = csr_from_ell(_host_leaf(store.cols),
                               _host_leaf(store.vals))
    else:
        triplet = csr_from_dense(_host_leaf(mat.logical_data()))
    sp.save_csr_matrix(path, *triplet, ncol=mat.shape[1])
    return get_dense_matrix(name)


def get_dense_matrix(name: str) -> FMMatrix:
    """fm.get.dense.matrix: reopen a named on-disk matrix (O(1), mmap).
    Dispatches on the stored format — a CSR ``.fmat`` reopens as a
    sparse-tier (CsrMmapStore-backed) matrix."""
    path = matrix_path(name)
    if not path.exists():
        raise KeyError(
            f"no on-disk matrix {name!r} under {os.fspath(data_dir())} "
            f"(have: {sorted(list_matrices())})")
    store = fmt.open_matrix(path)
    shape = getattr(store, "shape", None) or store.header.shape
    dtype = getattr(store, "dtype", None) or store.header.dtype
    return FMMatrix(shape, dtype, store=store, name=name)


def load_dense_matrix(src, name: str, *, ncol: Optional[int] = None,
                      dtype=None, delimiter: str = ",",
                      layout: str = "row", **ingest_kw) -> FMMatrix:
    """fm.load.dense.matrix: ingest an external file into the registry.

    ``src`` may be a ``.csv``/``.txt``/``.tsv`` text file, a ``.npy``
    array, a raw binary file (requires ``ncol``), or an in-memory array.
    Text and binary ingest stream through data.pipeline in bounded chunks.

    ``dtype=None`` keeps the source's own dtype for arrays and ``.npy``
    files, and defaults to float32 for text/raw-binary (whose element type
    is not self-describing)."""
    from ..data import pipeline as _pipeline
    dest = matrix_path(name)
    if isinstance(src, (str, os.PathLike)):
        suffix = pathlib.Path(src).suffix.lower()
        if suffix in (".csv", ".txt", ".tsv"):
            _pipeline.ingest_csv(src, dest, dtype=dtype or np.float32,
                                 delimiter=delimiter, layout=layout,
                                 **ingest_kw)
        elif suffix == ".npy":
            arr = np.load(src, mmap_mode="r")
            if dtype is not None:
                arr = np.asarray(arr, dtype=dtype)
            fmt.save_matrix(dest, arr, layout=layout)
        else:
            if ncol is None:
                raise ValueError("raw binary ingest requires ncol=")
            _pipeline.ingest_binary(src, dest, ncol=ncol,
                                    dtype=dtype or np.float32,
                                    layout=layout, **ingest_kw)
    else:
        if isinstance(src, torch.Tensor):
            src = fmt._host(src)
        arr = np.asarray(src) if dtype is None else np.asarray(src, dtype)
        fmt.save_matrix(dest, arr, layout=layout)
    return get_dense_matrix(name)


def load_factor_matrix(src, name: str, *, num_levels, dtype=np.float32,
                       delimiter: str = ",", **ingest_kw) -> FMMatrix:
    """fm.load.factor.matrix: stream a CSV of integer factor columns into
    the registry as a CSR ``.fmat`` of one-hot rows (the Criteo ingest —
    see data.pipeline.ingest_factor_csv) and reopen it sparse."""
    from ..data import pipeline as _pipeline
    _pipeline.ingest_factor_csv(src, matrix_path(name),
                                num_levels=num_levels, dtype=dtype,
                                delimiter=delimiter, **ingest_kw)
    return get_dense_matrix(name)


def delete_matrix(name: str):
    path = matrix_path(name)
    if path.exists():
        path.unlink()


def list_matrices() -> list[str]:
    if _CONF["data_dir"] is None:
        return []
    return sorted(p.stem for p in data_dir().glob("*.fmat"))
