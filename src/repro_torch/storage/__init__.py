"""Engine configuration (the conf part of repro.storage), the device
tier's sparse store (``SparseEllStore``) and partition staging
(``prefetch.stage_block``).  The background prefetcher comes with ROADMAP
A7a-ii; the disk tier — on-disk formats, mmap stores (dense and CSR),
named-matrix registry — with A7b."""
from . import prefetch, registry, sparse
from .registry import KNOWN_KNOBS, conf, device, get_conf, set_conf
from .sparse import SparseEllStore

__all__ = ["prefetch", "registry", "sparse", "KNOWN_KNOBS", "conf", "device",
           "get_conf", "set_conf", "SparseEllStore"]
