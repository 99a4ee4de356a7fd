"""Engine configuration (the conf part of repro.storage) and the device
tier's sparse store (``SparseEllStore``).  The disk tier — on-disk formats,
mmap stores (dense and CSR), prefetcher, named-matrix registry — comes with
ROADMAP A7."""
from . import registry, sparse
from .registry import KNOWN_KNOBS, conf, device, get_conf, set_conf
from .sparse import SparseEllStore

__all__ = ["registry", "sparse", "KNOWN_KNOBS", "conf", "device", "get_conf",
           "set_conf", "SparseEllStore"]
