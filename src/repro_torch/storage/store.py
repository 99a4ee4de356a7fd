"""MmapStore — the disk tier behind the ``MatrixStore`` protocol (PyTorch
port of repro.storage.store).

An on-disk matrix (format.py) served through ``np.memmap``: opening is
O(1), ``block()`` touches only the partition's pages, and nothing forces
the whole matrix into RAM.  ``on_host`` is True (partitions are staged
host→device, as for the RAM tier: ``storage.prefetch.stage_block`` reads a
block into host memory — the prefetcher's pinned slot, or a host copy —
and copies it to the card) and ``on_disk`` tells the tiers apart.

Writable stores (``format.create_matrix``) are the spill targets of
``save='disk'`` outputs: the streaming executor calls ``write_rows`` a
partition at a time (write-through), then ``flush``.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

import numpy as np

from ..core.matrix import MatrixStore
from .format import MatrixHeader


class MmapStore(MatrixStore):
    """Disk-backed matrix store over a single ``.fmat`` file."""

    def __init__(self, path, header: MatrixHeader, *, mode: str = "r",
                 _mm: Optional[np.memmap] = None, _layout: Optional[str] = None):
        self.path = pathlib.Path(path)
        self.header = header
        self.mode = mode
        self.layout = _layout if _layout is not None else header.layout
        self._fd: Optional[int] = None  # fadvise handle (direct_io mode)
        if _mm is not None:
            self._mm = _mm
        else:
            self._mm = np.memmap(self.path, dtype=header.dtype, mode=mode,
                                 offset=header.body_offset,
                                 shape=header.stored_shape)

    # -- MatrixStore protocol -------------------------------------------------
    @property
    def on_host(self) -> bool:
        return True

    @property
    def on_disk(self) -> bool:
        return True

    def _map(self) -> np.memmap:
        if self._mm is None:
            raise ValueError(f"{self.path}: the store is closed")
        return self._mm

    def logical(self):
        """The full matrix in logical orientation, as a lazy memmap view —
        pages fault in only where actually read."""
        mm = self._map()
        return mm.T if self.layout == "col" else mm

    def block(self, start: int, stop: int):
        mm = self._map()
        if self._direct_io():
            # Cache-bypass mode: read the partition into host memory, then
            # tell the kernel to drop its pages so the next pass re-reads
            # them from the device (cold reads; fm.set_conf(direct_io=True)).
            if self.layout == "col":
                out = np.ascontiguousarray(mm[:, start:stop].T)
            else:
                out = np.array(mm[start:stop])
            self.drop_cache(start, stop)
            return out
        if self.layout == "col":
            return mm[:, start:stop].T
        return mm[start:stop]

    @staticmethod
    def _direct_io() -> bool:
        from . import registry  # deferred: registry imports core at load
        return bool(registry.get_conf("direct_io"))

    def drop_cache(self, start: Optional[int] = None,
                   stop: Optional[int] = None):
        """Best-effort page-cache eviction of logical rows [start, stop)
        (or the whole body) via ``posix_fadvise(DONTNEED)``.  Dirty pages
        are not dropped: after a write, ``os.fsync`` the file first.

        'col'-layout stores interleave every logical row across the file,
        so a row range degrades to dropping the whole body.  No-op on
        platforms without posix_fadvise."""
        fadvise = getattr(os, "posix_fadvise", None)
        if fadvise is None or self._mm is None:  # pragma: no cover
            return
        h = self.header
        itemsize = np.dtype(h.dtype).itemsize
        if start is None or stop is None or self.layout == "col":
            offset, length = h.body_offset, self._mm.size * itemsize
        else:
            row_bytes = self._mm.shape[1] * itemsize
            offset = h.body_offset + start * row_bytes
            length = (stop - start) * row_bytes
        try:
            if self._fd is None:
                self._fd = os.open(self.path, os.O_RDONLY)
            fadvise(self._fd, offset, length, os.POSIX_FADV_DONTNEED)
        except OSError:  # pragma: no cover - best effort by design
            pass

    def nbytes(self) -> int:
        return int(self._map().size) * self._map().dtype.itemsize

    def transposed(self) -> "MmapStore":
        flipped = "col" if self.layout == "row" else "row"
        return MmapStore(self.path, self.header, mode=self.mode,
                         _mm=self._map(), _layout=flipped)

    # -- write-through spill ---------------------------------------------------
    @property
    def writable(self) -> bool:
        return self.mode in ("r+", "w+")

    def write_rows(self, start: int, arr: np.ndarray):
        """Write logical rows [start, start+len(arr)) — one partition of a
        long-dimension output streaming to disk."""
        if not self.writable:
            raise ValueError(f"{self.path} opened read-only")
        mm = self._map()
        arr = np.asarray(arr)
        if self.layout == "col":
            mm[:, start:start + arr.shape[0]] = arr.T
        else:
            mm[start:start + arr.shape[0]] = arr

    def flush(self):
        if self.writable and self._mm is not None:
            self._mm.flush()

    def close(self):
        """Flush and drop this store's mapping: further reads through the
        store raise.  Idempotent.

        The mapping itself is released when its last view goes, never
        here: a partition block, a staged CPU tensor (``torch.from_numpy``
        shares the pages) or a result may still view the file, and
        unmapping under it would fault on its next read.  (The reference
        closes the ``mmap`` here, and numpy views do not keep it mapped;
        ROADMAP §C.)"""
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:  # pragma: no cover
                pass
            self._fd = None
        if self._mm is None:
            return
        self.flush()
        self._mm = None

    def __repr__(self):
        h = self.header
        return (f"MmapStore({h.nrow}x{h.ncol}, {np.dtype(h.dtype).name}, "
                f"layout={self.layout!r}, path={os.fspath(self.path)!r})")
