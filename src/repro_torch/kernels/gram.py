"""Tall-skinny Gram kernel G = XᵀX and its two-operand form XᵀY on Hopper
(csrc/gram.cu).

``gram`` replaces repro/kernels/gram.py:gram (Pallas, `_gram_kernel`).  Bound on an
H100 at the main path's 65,608,366 × 32 f32: reading X is 8.40 GB, 2.51 ms
at 3.35 TB/s; the upper triangle is 640 FMAs a row, 8.4e10 FLOP, 1.25 ms at
the 67 TFLOP/s non-tensor f32 rate — so the kernel is bound by bytes.  Two
bodies, chosen by ``tri_plan`` from the shape:

* p ≤ ``TRI_MAX_P`` (the main path), ``fm_gram_tri``: wgram's triangle body
  without the weights (one source, ``tri_partials<T, FAST, WEIGHTED>``): the
  upper triangle in 8×8 register tiles, rows bulk-copied (``cp.async.bulk``)
  into an mbarrier ring of shared memory (csrc/gram.cu's note has the
  design).  X must start on a 16-byte boundary; a view that does not is
  copied first.  Counted in ``tri_launches`` as well as ``launches``.
* p > 32, ``fm_gram``: 32×32 output tiles × a row split over ~4 blocks per
  SM, rows staged through shared memory, a 4×4 register tile per thread.

Both write per-block partials to a workspace and sum them in a second
launch in a fixed order (deterministic).  Full f32 FMA; no TF32, no tensor
cores (the reference tests hold f32 at 1e-4).

``xty`` replaces repro/kernels/gram.py:xty (Pallas, `_xty_kernel`).  Two
operands both wider than ``THIN`` columns take the gram design with the
right tile staged from Y (n, q) and the (p, q) output tiled 32×32.  The main
path's shapes are thin — NMF's WᵀX with W (n, 8) and X (n, 32), GMM's Xᵀr
with X (n, 32) and r (n, 1) — and bound by reading both operands once:
n·(p + q)·4 bytes, 3.1 ms and 2.6 ms at 65,608,366 rows and 3.35 TB/s.
There a 32×32 tile would mostly multiply masked zeros, so a thin path takes
them (csrc/gram.cu's note has the design): the narrow width a compile-time
``thin_width(na)`` ∈ ``THIN_WIDTHS``, 16-byte loads of the wide operand
(eight threads a 32-column row), the narrow values of a row read as
vectors, the next rows prefetched into registers while the current ones are
multiplied, and lanes, warps and splits added in a fixed order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import build, ref
from .common import LAUNCH_LOCK, SM_COUNT, aligned, route, splits_for

TILE = 32
#: xty's thin path takes one operand at most this many columns wide.
THIN = 16
#: Narrow widths the thin path is built for (a narrower operand takes the
#: next one up, its missing columns read as zeros; ``fm_xty`` dispatches),
#: each with the blocks a launch gives an SM (the splits are this many
#: times the SM count over the wide tiles): the fastest on the H100 at
#: GMM's width 1 (8) and NMF's width 8 (12) (PERF.md); widths 2, 4
#: and 16 were not measured and take 8.  How many blocks are resident at
#: once is the kernel's launch bound (``ThinCfg::MINB`` in csrc/gram.cu).
THIN_BLOCKS = {1: 8, 2: 8, 4: 8, 8: 12, 16: 8}
THIN_WIDTHS = tuple(THIN_BLOCKS)
#: Launches of the CUDA kernels (the plain CPU path does not count):
#: ``launches`` counts every gram call that launched, ``tri_launches`` those
#: that ran the triangle body (p ≤ TRI_MAX_P).
launches = 0
tri_launches = 0
xty_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_x(x: torch.Tensor, what: str):
    if x.ndim != 2:
        raise ValueError(f"{what}: X must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: X must be float32 or bfloat16, got {x.dtype}")


def gram_splits(n: int, p: int, q: int | None = None) -> int:
    tiles = -(-p // TILE) * -(-(p if q is None else q) // TILE)
    return splits_for(n, 256, tiles)


def gram(x: torch.Tensor) -> torch.Tensor:
    """G = XᵀX for tall (n, p) X (float32 or bfloat16); (p, p) float32."""
    global launches, tri_launches
    check_x(x, "gram")
    if route(x) == "cpu":
        return ref.gram_ref(x)
    x = x.contiguous()
    n, p = x.shape
    plan = tri_plan(n, p, x.dtype, weighted=False)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((p, p), dtype=torch.float32, device=x.device)
    lib = build.load("gram")
    stream = build.stream_handle(x)
    if plan.body == "tri":
        x = aligned(x)
        err = lib.fm_gram_tri(x.data_ptr(), ws.data_ptr(), out.data_ptr(), n,
                              p, plan.chunk_rows, plan.stages,
                              plan.rows_per_split, plan.splits,
                              _DTYPES[x.dtype], stream)
    else:
        err = lib.fm_gram(x.data_ptr(), ws.data_ptr(), out.data_ptr(), n, p,
                          plan.splits, _DTYPES[x.dtype], stream)
    build.check(err, "gram")
    with LAUNCH_LOCK:
        launches += 1
        tri_launches += plan.body == "tri"
    return out


def thin_width(na: int) -> int:
    """The built narrow width that serves an operand ``na`` columns wide
    (1 ≤ na ≤ THIN), as ``launch_thin`` in csrc/gram.cu picks it."""
    if not 1 <= na <= THIN:
        raise ValueError(f"xty thin path: narrow width {na} outside 1..{THIN}")
    return next(w for w in THIN_WIDTHS if w >= na)


def xty_plan(n: int, p: int, q: int) -> tuple[int, int]:
    """(splits, workspace floats) of an xty launch, a function of the shape
    only: the thin path when min(p, q) ≤ THIN (one block per 32 wide
    columns and split, ``THIN_BLOCKS`` blocks an SM), else the 32×32
    tiles."""
    if min(p, q) <= THIN:
        wide_tiles = -(-max(p, q) // TILE)
        blocks = THIN_BLOCKS[thin_width(min(p, q))]
        splits = splits_for(n, 1024, wide_tiles, blocks * SM_COUNT)
        return splits, splits * wide_tiles * THIN * TILE
    splits = gram_splits(n, p, q)
    return splits, splits * -(-p // TILE) * -(-q // TILE) * TILE * TILE


#: The triangle body of gram and wgram (csrc/gram.cu tri_partials): the
#: widest p it takes, its threads, blocks an SM (its launch bound), ring
#: stages and the bytes a stage aims at.
TRI_MAX_P = 32
TRI_THREADS = 256
TRI_BLOCKS_PER_SM = 2
TRI_STAGES = 3
TRI_STAGE_BYTES = 32 * 1024
#: Shared bytes before the ring (one mbarrier a stage), TRI_BARS in gram.cu.
TRI_BARS = 64


class TriPlan(NamedTuple):
    """The launch of one gram or wgram call.  body "tri": p ≤ TRI_MAX_P,
    chunks of chunk_rows rows (and their weights, for wgram) bulk-copied
    into ``stages`` stages of shared memory, one block a split of
    rows_per_split rows; "tile": the 32×32 tile body (gram_partials), which
    stages through static shared memory (chunk_rows, stages and smem_bytes
    0)."""
    body: str
    splits: int
    rows_per_split: int
    chunk_rows: int
    stages: int
    smem_bytes: int
    ws_floats: int


def tri_plan(n: int, p: int, dtype: torch.dtype, weighted: bool) -> TriPlan:
    """gram's (``weighted`` False) or wgram's geometry, a function of (n, p,
    dtype, weighted) alone.  A row in shared memory is p values, and its
    f32 weight when ``weighted``.  The triangle body's chunk is the most
    rows, a multiple of 8 (so a chunk of f32 or bf16 rows is a multiple of
    16 bytes at any p) and of the rows a block takes a step, that fit
    TRI_STAGE_BYTES; its splits are TRI_BLOCKS_PER_SM blocks an SM or one a
    chunk, whichever is fewer, each a whole number of chunks."""
    if p > TRI_MAX_P:
        splits = gram_splits(n, p)
        tiles = -(-p // TILE)
        return TriPlan("tile", splits, -(-n // splits), 0, 0, 0,
                       splits * tiles * tiles * TILE * TILE)
    row_bytes = p * (2 if dtype == torch.bfloat16 else 4) + 4 * weighted
    nb = -(-p // 8)
    step = TRI_THREADS // 32 * (32 // (nb * (nb + 1) // 2))
    unit = math.lcm(8, step)
    rows = max(unit, TRI_STAGE_BYTES // row_bytes // unit * unit)
    red = TRI_THREADS // 32 * nb * (nb + 1) // 2 * 64 * 4
    smem = TRI_BARS + max(TRI_STAGES * rows * row_bytes, red)
    chunks = -(-n // rows)
    per = max(1, -(-chunks // max(1, min(TRI_BLOCKS_PER_SM * SM_COUNT,
                                         chunks))))
    rps = per * rows
    splits = max(1, -(-n // rps))
    return TriPlan("tri", splits, rps, rows, TRI_STAGES, smem, splits * p * p)


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """XᵀY for row-aligned tall X (n, p) and Y (n, q) of one dtype (float32
    or bfloat16); (p, q) float32."""
    global xty_launches
    check_x(x, "xty")
    check_x(y, "xty")
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"xty: X {tuple(x.shape)} and Y {tuple(y.shape)} "
                         "are not row-aligned")
    if y.dtype != x.dtype:
        raise TypeError(f"xty: X and Y must share a dtype, got {x.dtype} "
                        f"and {y.dtype}")
    if route(x, y) == "cpu":
        return ref.xty_ref(x, y)
    x, y = x.contiguous(), y.contiguous()
    n, p = x.shape
    q = y.shape[1]
    splits, ws_floats = xty_plan(n, p, q)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((p, q), dtype=torch.float32, device=x.device)
    lib = build.load("gram")
    err = lib.fm_xty(x.data_ptr(), y.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     n, p, q, splits, _DTYPES[x.dtype], build.stream_handle(x))
    build.check(err, "xty")
    with LAUNCH_LOCK:
        xty_launches += 1
    return out
