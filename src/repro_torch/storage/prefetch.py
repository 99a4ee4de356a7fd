"""Partition staging (PyTorch port of repro.storage.prefetch, its
``stage_block``).

``stage_block`` is the one definition of how an I/O-level partition of a
source reaches the fused step.  The reference shares it between its
synchronous path (the executor's ``_inline_partitions``, the prefetch-off
ablation) and its background ``PartitionPrefetcher``.  The port has the
synchronous path: the prefetcher — pinned staging buffers, a side CUDA
stream and events, ``negotiate_depth``, ``PrefetchError`` and the leak
audit — comes with ROADMAP A7a-ii.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..observability import metrics
from ..observability.trace import TRACER


def stage_block(mat, start: int, stop: int):
    """Read rows [start, stop) of ``mat`` and stage them on the engine's
    device for the fused step:

    * a host-tier (numpy) block is made contiguous — the slow-tier read,
      counted in ``stage_bytes_read`` / ``stage_read_seconds`` — and then
      copied to the device.  From pageable host memory that copy is
      synchronous: the step of this partition starts after it lands;
    * a device-tier block (dense, or an ELL slab's ``SparseBlock``; a
      host-RAM slab comes with ROADMAP A7a-ii) is passed through as the
      store's own view, with no tier read.  The reference copies a device
      block when its consumer will donate it, because donation hands the
      buffer to XLA; PyTorch has no donation, and no step writes into its
      inputs (``whole`` mode hands the step the store's own tensors the
      same way), so the view is safe without a copy.

    Records a ``stage`` span.  An error (a failed read of the store)
    propagates unchanged to the caller."""
    from . import registry  # deferred: registry imports core
    t0 = time.perf_counter()
    blk = mat.block(start, stop)
    if isinstance(blk, np.ndarray):
        blk = np.ascontiguousarray(blk)
        metrics.inc("stage_bytes_read", blk.nbytes)
        metrics.inc("stage_read_seconds", time.perf_counter() - t0)
        blk = torch.from_numpy(blk).to(registry.device())
    TRACER.record("stage", t0, time.perf_counter(),
                  {"start": int(start), "stop": int(stop)})
    return blk
