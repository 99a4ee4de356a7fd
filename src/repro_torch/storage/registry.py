"""Engine configuration: the conf part of repro.storage.registry.

The knob names are the reference's (``KNOWN_KNOBS``), so one test program
configures both packages, plus ``device``: the ``torch.device`` every
matrix and every accumulator lives on.  It is ``cuda`` unless the caller
asks for the CPU (``fm.set_conf(device="cpu")`` or ``fm.conf(device=
"cpu")``); with no card and no such request, ``device()`` raises rather
than carry on quietly on the CPU.

The named-matrix registry and the disk tier (``data_dir`` is accepted and
recorded) come with the disk-tier slice (ROADMAP A7b); ``mesh`` with the
multi-GPU slice (ROADMAP A13).
"""
from __future__ import annotations

import contextlib
import difflib
import threading

import torch

from ..core import lowering as lowering_mod
from ..core import matrix as matrix_mod

_CONF = {
    "data_dir": None,       # recorded; the disk tier is ROADMAP A7b
    "prefetch": True,       # default for ooc execution
    "prefetch_depth": 2,    # bounded-queue depth
    "direct_io": False,     # page-cache bypass on partition reads (A7b)
    "mesh": None,           # sharded execution (ROADMAP A13)
    "device": "cuda",       # where matrices, partials and results live
}

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
    with _CONF_LOCK:
        for k in ("data_dir", "prefetch", "direct_io"):
            if kw.get(k) is not None:
                _CONF[k] = kw[k]
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
