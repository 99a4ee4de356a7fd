"""Shared helpers of the Hopper kernel wrappers.

The CUDA kernels choose their own tiling (each says how in its source note)
and never pad X: they mask the ragged edge.  The plan IR's ``block_rows``
rule, which the reference also applies to its kernels, lives in
``core/matrix.py`` (``proc_partition_rows``).  ``route`` is the one place a
wrapper decides between its kernel and its plain version.
"""
from __future__ import annotations

import threading

import torch

#: Guards every wrapper's launch counters (module globals read by name, as
#: ``gram.launches``): ``fm.serve`` launches kernels from several worker
#: threads at once, and ``+=`` on a global is not atomic.
LAUNCH_LOCK = threading.Lock()

#: Streaming multiprocessors of one H100 SXM: the split counts below aim at
#: a few resident blocks per SM.
SM_COUNT = 132


def route(*tensors: torch.Tensor) -> str:
    """'cpu' when every tensor lies on the CPU (the wrapper then runs its
    plain version), 'cuda' when every tensor lies on one CUDA device (the
    wrapper launches its kernel); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def splits_for(n: int, min_rows: int, blocks_per_split: int = 1,
               target_blocks: int = 4 * SM_COUNT) -> int:
    """Row splits of a split-reduction launch: enough blocks to fill the
    card, no split smaller than ``min_rows`` rows, at most 65535 (the grid
    limit of the dimension that carries them).  A function of the shapes
    only, so the reduction order — and the result — is reproducible."""
    by_rows = max(1, -(-n // max(1, min_rows)))
    by_card = max(1, target_blocks // max(1, blocks_per_split))
    return int(min(by_rows, by_card, 65535))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy of it when its base is off a 16-byte boundary
    (the bulk copies and TMA loads need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
