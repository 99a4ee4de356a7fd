"""Storage tiers (PyTorch port of repro.storage, the paper's SSD layer).

  * `format`   — the on-disk single-file matrix format (.fmat): magic +
    shape/dtype/layout header, page-aligned row-contiguous body, byte for
    byte the reference's.  `save_matrix` / `open_matrix` / `create_matrix`.
  * `store`    — `MmapStore`, the `core.matrix.MatrixStore` backend that
    serves I/O-level partitions straight from the file via np.memmap.
  * `prefetch` — `stage_block` and `PartitionPrefetcher`, the background
    stager that overlaps the disk or host-RAM read and the host→device copy
    (pinned slots, a side CUDA stream) with the steps.
  * `registry` — engine configuration (`set_conf`, `conf`, `device`) and
    the named-matrix surface (`load_dense_matrix` / `get_dense_matrix` /
    `save_dense_matrix`, `load_factor_matrix`).
  * `sparse`   — the CSR variant of the .fmat container, served as ELL
    SparseBlocks (`CsrMmapStore`), and the in-memory `SparseEllStore` (a
    host or device slab).
"""
from . import format, prefetch, registry, sparse, store
from .format import (MatrixHeader, create_matrix, open_matrix, peek_format,
                     read_header, save_matrix)
from .prefetch import (PartitionPrefetcher, PrefetchError, live_prefetchers,
                       negotiate_depth, stage_block, staged_leaks)
from .registry import (KNOWN_KNOBS, cleanup, conf, device, get_conf,
                       get_dense_matrix, list_matrices, load_dense_matrix,
                       load_factor_matrix, save_dense_matrix,
                       save_sparse_matrix, set_conf, spill_path)
from .sparse import (CsrMmapStore, SparseEllStore, open_csr, read_csr_meta,
                     save_csr_matrix)
from .store import MmapStore

__all__ = [
    "format", "prefetch", "registry", "sparse", "store",
    "CsrMmapStore", "KNOWN_KNOBS", "MatrixHeader", "MmapStore",
    "PartitionPrefetcher", "PrefetchError", "SparseEllStore",
    "cleanup", "conf", "create_matrix", "device", "get_conf",
    "get_dense_matrix", "list_matrices", "live_prefetchers",
    "load_dense_matrix", "load_factor_matrix", "negotiate_depth",
    "open_csr", "open_matrix", "peek_format",
    "read_csr_meta", "read_header", "save_csr_matrix", "save_dense_matrix",
    "save_matrix", "save_sparse_matrix", "set_conf", "spill_path",
    "stage_block", "staged_leaks",
]
