"""Sparse (ELL) contraction kernels on Hopper (csrc/spmm.cu): XᵀX, XᵀY and
XᵀWX for the one-hot tier.

Replace repro/kernels/spmm.py:spmm_gram, spmm_xty and spmm_wgram (Pallas).
X arrives as an ELL slab — ``cols`` int32 and ``vals`` of shape (n, kmax),
padded with (col 0, val 0) — and its HBM traffic stays nnz-proportional: the
kernels read 8·kmax bytes a row and never form a dense row.

Bound on an H100 at the Criteo shape (n = 45,840,617, kmax = 26, ncol =
1,664): reading the slab is 9.53 GB, about 2.85 ms at 3.35 TB/s (plus n·4
bytes of w or Y: 2.90 ms for spmm_wgram and spmm_xty at q = 1); the
n·kmax² = 3.1e10 pair products are 0.93 ms at the f32 rate.  What sets their
time is neither: the (ncol, ncol) output (11.1 MB) does not fit in shared
memory, so every pair product is an atomic add into an output tile that does.
The output is cut into shared-memory tiles (upper-triangle square tiles of
XᵀX and XᵀWX, mirrored at the end; stripes of XᵀY), one block per (tile,
split of the rows) adds the products that fall into its tile, the blocks of
a split run side by side so the slab is read from device memory about once
(from L2 once per tile), and a second launch adds the splits' partial tiles
in a fixed order.  Rows per split and the workspace are capped
(``WS_CAP_BYTES``), so no f32 accumulator sums more than one split's rows.

XᵀX and XᵀWX (``gram_tile``): 1,024 threads a block and the whole of its
shared memory for one tile (ts = 240 at Criteo: 28 tiles), a warp per row,
the row's entries on its lanes straight from global memory, any kmax.  XᵀY
(``xty_tile``) takes a warp a row the same way, but each warp adds into a
copy of the stripe of its own (32 copies of all 1,664 rows at Criteo, one
stripe), so it needs no atomics, adds in a fixed order (the same bits on
every call) and takes any kmax.

On CPU tensors each wrapper runs its plain version in ``ref``.
"""
from __future__ import annotations

import math

import torch

from . import build, ref
from .common import LAUNCH_LOCK, SM_COUNT, route

#: Launches of the CUDA kernels (the plain CPU path does not count).
gram_launches = 0
xty_launches = 0
wgram_launches = 0

#: Threads of a gram / wgram block: 32 warps, one block an SM.
GRAM_THREADS = 1024
#: Shared memory a block may take on an H100 (227 KB).
SMEM_LIMIT = 232448
#: Most and fewest warps of an xty block (each holds a copy of the stripe).
XTY_MAX_WARPS = 32
XTY_MIN_WARPS = 8
#: Rows a warp of xty has in flight (XTY_AHEAD in csrc/spmm.cu).
XTY_AHEAD = 6
#: Cap on the workspace of per-split partial tiles.
WS_CAP_BYTES = 1 << 30
#: Fewest rows a split takes (more splits than n allows leave blocks idle).
MIN_SPLIT_ROWS = 4096


def check_ell(cols: torch.Tensor, vals: torch.Tensor, ncol: int, what: str):
    if cols.ndim != 2 or vals.shape != cols.shape:
        raise ValueError(f"{what}: cols and vals must be (n, kmax) of one "
                         f"shape, got {tuple(cols.shape)} and "
                         f"{tuple(vals.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{what}: cols must be int32, got {cols.dtype}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: vals must be float32 or bfloat16, got "
                        f"{vals.dtype}")
    if int(ncol) < 1:
        raise ValueError(f"{what}: ncol must be positive, got {ncol}")


def _rows(t: torch.Tensor, n: int, what: str, name: str) -> torch.Tensor:
    """A row-aligned (n,) or (n, q) operand as float32, contiguous."""
    if t.shape[0] != n or t.ndim > 2:
        raise ValueError(f"{what}: {name} must have {n} rows, got "
                         f"{tuple(t.shape)}")
    if not t.is_floating_point():
        raise TypeError(f"{what}: {name} must be floating, got {t.dtype}")
    return t.to(torch.float32).contiguous()


def gram_tile(ncol: int) -> int:
    """The square tile edge of spmm_gram / spmm_wgram: a multiple of 8 whose
    tile fills one block's shared memory, at most ncol rounded up to 8."""
    return min(math.isqrt(SMEM_LIMIT // 4) // 8 * 8, -(-ncol // 8) * 8)


def xty_copy_floats(floats: int) -> int:
    """Floats of one warp's copy of a stripe of ``floats`` outputs, indexed
    by skew(e) = e + (e >> 6) (csrc/spmm.cu: one float of padding every 64
    spreads the one-hot levels over the banks)."""
    return floats + (floats - 1) // 64


def xty_tile(ncol: int, q: int) -> tuple[int, int, int]:
    """(cs, qc, warps): stripes of cs output rows × qc of Y's columns and
    the warps of a block, each with a copy of the stripe, all inside one
    block's shared memory.  The whole of ncol is one stripe when it leaves
    room for XTY_MIN_WARPS copies, with as many warps as fit (at most
    XTY_MAX_WARPS); else the stripe is cut to the rows XTY_MIN_WARPS copies
    leave.  Rows are read from global memory, so kmax plays no part."""
    qc = min(q, 32)
    floats = SMEM_LIMIT // 4
    warps = min(XTY_MAX_WARPS, floats // xty_copy_floats(ncol * qc))
    if warps >= XTY_MIN_WARPS:
        return ncol, qc, warps
    per = floats // XTY_MIN_WARPS
    return per * 64 // 65 // qc, qc, XTY_MIN_WARPS


def spmm_splits(n: int, tiles: int, tile_floats: int) -> int:
    """Row splits: about four blocks an SM, a split of at least
    MIN_SPLIT_ROWS rows, and a workspace of at most WS_CAP_BYTES; a function
    of the shapes only, so the combine order is reproducible."""
    by_card = -(-4 * SM_COUNT // tiles)
    by_rows = max(1, -(-n // MIN_SPLIT_ROWS))
    by_ws = max(1, WS_CAP_BYTES // (4 * tiles * tile_floats))
    return int(max(1, min(max(by_card, -(-n // (1 << 18))), by_rows, by_ws,
                          65535)))


def xty_layout(n: int, ncol: int, q: int) -> tuple[int, int, int, int, int]:
    """(cs, qc, warps, tiles, splits) of a spmm_xty launch."""
    cs, qc, warps = xty_tile(ncol, q)
    tiles = -(-ncol // cs) * -(-q // qc)
    return cs, qc, warps, tiles, spmm_splits(n, tiles, cs * qc)


def gram_layout(n: int, ncol: int) -> tuple[int, int, int]:
    """(ts, tiles, splits) of a spmm_gram / spmm_wgram launch."""
    ts = gram_tile(ncol)
    nst = -(-ncol // ts)
    tiles = nst * (nst + 1) // 2
    return ts, tiles, spmm_splits(n, tiles, ts * ts)


def _gram(cols, vals, w, ncol: int, what: str):
    n, kmax = cols.shape
    ts, tiles, splits = gram_layout(n, ncol)
    dev = cols.device
    ws = torch.empty(splits * tiles * ts * ts, dtype=torch.float32, device=dev)
    out = torch.empty((ncol, ncol), dtype=torch.float32, device=dev)
    lib = build.load("spmm")
    stream = build.stream_handle(cols)
    if w is None:
        err = lib.fm_spmm_gram(cols.data_ptr(), vals.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), n, kmax, ncol, ts, splits,
                               stream)
    else:
        err = lib.fm_spmm_wgram(cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
                                ws.data_ptr(), out.data_ptr(), n, kmax, ncol,
                                ts, splits, stream)
    build.check(err, what)
    return out


def spmm_gram(cols: torch.Tensor, vals: torch.Tensor, *,
              ncol: int) -> torch.Tensor:
    """G = XᵀX for ELL X (n rows, ncol logical columns); (ncol, ncol) f32."""
    global gram_launches
    check_ell(cols, vals, ncol, "spmm_gram")
    if route(cols, vals) == "cpu":
        return ref.spmm_gram_ref(cols, vals, ncol)
    out = _gram(cols.contiguous(), vals.to(torch.float32).contiguous(), None,
                int(ncol), "spmm_gram")
    with LAUNCH_LOCK:
        gram_launches += 1
    return out


def spmm_wgram(cols: torch.Tensor, vals: torch.Tensor, w: torch.Tensor, *,
               ncol: int) -> torch.Tensor:
    """G = XᵀWX for ELL X and per-row weights w (n,) or (n, 1): the sparse
    IRLS hot spot; (ncol, ncol) f32."""
    global wgram_launches
    check_ell(cols, vals, ncol, "spmm_wgram")
    n = cols.shape[0]
    if w.numel() != n or (w.ndim == 2 and w.shape[1] != 1):
        raise ValueError(f"spmm_wgram: w must be (n,) or (n, 1) with n={n}, "
                         f"got {tuple(w.shape)}")
    if route(cols, vals, w) == "cpu":
        return ref.spmm_wgram_ref(cols, vals, w, ncol)
    w = _rows(w.reshape(-1), n, "spmm_wgram", "w")
    out = _gram(cols.contiguous(), vals.to(torch.float32).contiguous(), w,
                int(ncol), "spmm_wgram")
    with LAUNCH_LOCK:
        wgram_launches += 1
    return out


def spmm_xty(cols: torch.Tensor, vals: torch.Tensor, y: torch.Tensor, *,
             ncol: int) -> torch.Tensor:
    """XᵀY for ELL X and row-aligned dense Y (n, q); (ncol, q) f32."""
    global xty_launches
    check_ell(cols, vals, ncol, "spmm_xty")
    n, kmax = cols.shape
    if y.ndim != 2:
        raise ValueError(f"spmm_xty: y must be (n, q), got {tuple(y.shape)}")
    if route(cols, vals, y) == "cpu":
        _rows(y, n, "spmm_xty", "y")
        return ref.spmm_xty_ref(cols, vals, y, ncol)
    y = _rows(y, n, "spmm_xty", "y")
    q = y.shape[1]
    ncol = int(ncol)
    cs, qc, warps, tiles, splits = xty_layout(n, ncol, q)
    cols = cols.contiguous()
    vals = vals.to(torch.float32).contiguous()
    dev = cols.device
    ws = torch.empty(splits * tiles * cs * qc, dtype=torch.float32, device=dev)
    out = torch.empty((ncol, q), dtype=torch.float32, device=dev)
    lib = build.load("spmm")
    err = lib.fm_spmm_xty(cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
                          ws.data_ptr(), out.data_ptr(), n, kmax, ncol, q, qc,
                          cs, warps, splits, build.stream_handle(cols))
    build.check(err, "spmm_xty")
    with LAUNCH_LOCK:
        xty_launches += 1
    return out
