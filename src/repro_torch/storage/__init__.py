"""Engine configuration (the conf part of repro.storage), the in-memory
sparse store (``SparseEllStore``, host or device), partition staging
(``prefetch.stage_block``) and the background partition prefetcher.  The
disk tier — on-disk formats, mmap stores (dense and CSR), named-matrix
registry — comes with ROADMAP A7b."""
from . import prefetch, registry, sparse
from .prefetch import (PartitionPrefetcher, PrefetchError, live_prefetchers,
                       negotiate_depth, staged_leaks)
from .registry import KNOWN_KNOBS, conf, device, get_conf, set_conf
from .sparse import SparseEllStore

__all__ = ["prefetch", "registry", "sparse", "KNOWN_KNOBS", "conf", "device",
           "get_conf", "set_conf", "PartitionPrefetcher", "PrefetchError",
           "live_prefetchers", "negotiate_depth", "staged_leaks",
           "SparseEllStore"]
