"""Fused Lloyd-step kernel on Hopper (csrc/kmeans_assign.cu).

Replaces repro/kernels/kmeans_assign.py:kmeans_assign (Pallas, `_kernel`):
D = ‖x‖² − 2XCᵀ + ‖c‖², labels = argmin D (first index on ties, int32),
per-cluster sums and counts, and the objective wss, from one read of X.
Bound on an H100 at 65,608,366 × 32 f32 with k = 10: reading X (8.4 GB) and
writing the labels (0.26 GB), about 2.6 ms at 3.35 TB/s; the 2nkp FMAs are
0.6 ms at the f32 rate.  Both bodies walk 256-row chunks on a persistent
grid, one thread a row finding its label; sums and counts are gathered by
owner threads in row order (no atomics, deterministic), and a last launch
combines the blocks in order.  ``lloyd_plan`` picks the body from the
shape:

* p ≤ 32 in rows of 16 to 128 bytes (f32 p ∈ {4, 8, …, 32}, bf16 p ∈
  {8, 16, 24, 32}) whose centers fit in shared memory (the main path),
  ``fm_kmeans_assign_tma``: chunks by TMA (a 2-D tensor map, 128-byte
  swizzle) into an mbarrier ring, the row read once into registers, the
  centers read as broadcasts, ‖c‖² computed in the block (two CUDA
  launches: partials, combine; csrc/kmeans_assign.cu's note has the
  design).  X must start on a 16-byte boundary; a view that does not is
  copied first.
* every other shape, ``fm_kmeans_assign`` (the staged body): a chunk staged
  with coalesced loads; centers and ‖c‖² (a first launch) in dynamic shared
  memory, either read from global memory when it would crowd out the row
  tile, so no shape the reference takes is refused (three launches).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build, ref
from .common import LAUNCH_LOCK, SM_COUNT, aligned, route

#: Launches of the CUDA kernels (the plain CPU path does not count):
#: ``launches`` counts every call that launched, ``tma_launches`` those that
#: ran the TMA body.
launches = 0
tma_launches = 0

ROWS_PER_CHUNK = 256
#: Dynamic shared memory a block may take: the H100's 227 KB per block; an
#: SM holds 228 KB, 1 KB of it reserved a block.
SMEM_LIMIT = 232448
SM_SMEM = 233472
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The TMA body (csrc/kmeans_assign.cu lloyd_tma_partials): its threads
#: (one a row of a box), the widest p it takes (the row's values sit in
#: registers: at most 128 bytes, the swizzle's span), the shared bytes a
#: staged row takes (TMA pads a narrower row to the swizzle's span),
#: the ring stages it tries, the centers whose dot products run together (k
#: is padded to a multiple), the columns a gather thread adds and the shared
#: bytes of the barriers.
TMA_THREADS = ROWS_PER_CHUNK
TMA_MAX_P = 32
TMA_PITCH = 128
TMA_STAGES = (3, 2)
TMA_KB = 2
TMA_GATHER_COLS = 4
TMA_BARS = 64


class LloydPlan(NamedTuple):
    """The launch of one kmeans_assign call.  body "tma": boxes of
    box_rows rows into ``stages`` stages, ``blocks`` persistent blocks
    (blocks_per_sm an SM), the sum partials in ``lanes`` row lanes of
    shared memory (part_smem) or in the block's workspace slice (one lane);
    "staged": the staged body, which lays out its own shared memory (stages,
    lanes, part_smem and smem_bytes 0)."""
    body: str
    box_rows: int
    stages: int
    blocks: int
    blocks_per_sm: int
    lanes: int
    part_smem: bool
    smem_bytes: int
    ws_floats: int


def tma_smem(p: int, k: int, stages: int, lanes: int, part_smem: bool) -> int:
    """Shared bytes of a TMA block, as ``tma_smem`` in the source: 1024 to
    align the ring, the ring, the barriers, the partials when shared, the
    centers and ‖c‖² (k padded to TMA_KB), labels and the wss reduction."""
    k2 = -(-k // TMA_KB) * TMA_KB
    b = 1024 + stages * ROWS_PER_CHUNK * TMA_PITCH + TMA_BARS
    b += lanes * k * (p + 1) * 4 if part_smem else 0
    return b + (k2 * p + k2) * 4 + 2 * ROWS_PER_CHUNK * 4


def lloyd_plan(n: int, p: int, k: int, dtype: torch.dtype) -> LloydPlan:
    """kmeans_assign's geometry, a function of (n, p, k, dtype) alone.  The
    TMA body takes p ≤ TMA_MAX_P in rows of p·elem bytes, a multiple of 16
    (TMA's stride rule), and 1 ≤ n < 2³¹.  It runs two blocks an SM
    when the most stages of TMA_STAGES fit twice with every gather lane
    (TMA_THREADS / (p / TMA_GATHER_COLS)) in shared memory; else one, with
    the most lanes that fit beside the most stages; else the partials in the
    workspace (one lane).  Never more blocks than chunks.  Every other shape
    takes the staged body."""
    chunks = -(-n // ROWS_PER_CHUNK)
    elem = 2 if dtype == torch.bfloat16 else 4
    pb = p * elem

    def plan(stages, per_sm, lanes, part):
        blocks = max(1, min(chunks, per_sm * SM_COUNT))
        return LloydPlan("tma", ROWS_PER_CHUNK, stages, blocks, per_sm, lanes,
                         part, tma_smem(p, k, stages, lanes, part),
                         blocks * (k * p + k + 1))

    if p <= TMA_MAX_P and pb % 16 == 0 and 1 <= n < 2 ** 31:
        most = TMA_THREADS // (p // TMA_GATHER_COLS)
        for stages in TMA_STAGES:
            if 2 * (tma_smem(p, k, stages, most, True) + 1024) <= SM_SMEM:
                return plan(stages, 2, most, True)
        for stages in TMA_STAGES:
            lanes = next((ln for ln in range(most, 0, -1)
                          if tma_smem(p, k, stages, ln, True) <= SMEM_LIMIT),
                         0)
            if lanes:
                return plan(stages, 1, lanes, True)
        for stages in TMA_STAGES:
            if tma_smem(p, k, stages, 1, False) <= SMEM_LIMIT:
                return plan(stages, 1, 1, False)
    blocks = max(1, min(chunks, 4 * SM_COUNT))
    return LloydPlan("staged", ROWS_PER_CHUNK, 0, blocks, 4, 0, False, 0,
                     blocks * (k * p + k + 1) + k)


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor):
    """One fused Lloyd step for x (n, p) and centers (k, p).  Returns
    (labels (n,) int32, sums (k, p) f32, counts (k,) f32, wss (1,) f32)."""
    global launches, tma_launches
    if x.ndim != 2 or centers.ndim != 2 or centers.shape[1] != x.shape[1]:
        raise ValueError(f"kmeans_assign: x (n, p) and centers (k, p) needed, "
                         f"got {tuple(x.shape)} and {tuple(centers.shape)}")
    if x.dtype not in _DTYPES or not centers.is_floating_point():
        raise TypeError(f"kmeans_assign: x must be float32 or bfloat16 and "
                        f"centers floating, got {x.dtype}, {centers.dtype}")
    if route(x, centers) == "cpu":
        return ref.kmeans_assign_ref(x, centers)
    x = x.contiguous()
    c = centers.to(torch.float32).contiguous()
    n, p = x.shape
    k = c.shape[0]
    plan = lloyd_plan(n, p, k, x.dtype)
    dev = x.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    sums = torch.empty((k, p), dtype=torch.float32, device=dev)
    cnts = torch.empty(k, dtype=torch.float32, device=dev)
    wss = torch.empty(1, dtype=torch.float32, device=dev)
    lib = build.load("kmeans_assign")
    stream = build.stream_handle(x)
    if plan.body == "tma":
        x = aligned(x)
        err = lib.fm_kmeans_assign_tma(
            x.data_ptr(), c.data_ptr(), labels.data_ptr(), ws.data_ptr(),
            sums.data_ptr(), cnts.data_ptr(), wss.data_ptr(), n, p, k,
            plan.blocks, plan.stages, plan.lanes, int(plan.part_smem),
            _DTYPES[x.dtype], stream)
    else:
        err = lib.fm_kmeans_assign(
            x.data_ptr(), c.data_ptr(), labels.data_ptr(), ws.data_ptr(),
            sums.data_ptr(), cnts.data_ptr(), wss.data_ptr(), n, p, k,
            plan.blocks, SMEM_LIMIT, _DTYPES[x.dtype], stream)
    build.check(err, "kmeans_assign")
    with LAUNCH_LOCK:
        launches += 1
        tma_launches += plan.body == "tma"
    return labels, sums, cnts, wss
