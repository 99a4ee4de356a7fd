"""Engine configuration (the conf part of repro.storage).  The disk tier —
on-disk format, mmap stores, prefetcher, named-matrix registry — comes with
ROADMAP A7."""
from . import registry
from .registry import KNOWN_KNOBS, conf, device, get_conf, set_conf

__all__ = ["registry", "KNOWN_KNOBS", "conf", "device", "get_conf",
           "set_conf"]
