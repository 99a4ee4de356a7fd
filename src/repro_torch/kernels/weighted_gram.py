"""Weighted Gram kernel G = XᵀWX on Hopper (csrc/gram.cu).

Replaces repro/kernels/weighted_gram.py:wgram (Pallas, `_wgram_kernel`), the
IRLS hot spot.  Bound on an H100 at the main path's 65,608,366 × 32 f32:
reading X and w is 8.66 GB, 2.59 ms at 3.35 TB/s.  Two bodies, chosen by
``gram.tri_plan(n, p, dtype, weighted=True)`` from the shape:

* p ≤ 32 (the main path), ``fm_wgram_tri``: the triangle body that gram
  also runs (one source, ``tri_partials<T, FAST, WEIGHTED>``), here with
  the weights: the upper triangle only, in 8×8 register tiles (640 FMAs a
  row at p = 32, not 1,024), the row side multiplied by w in registers once
  per value, rows and their weights bulk-copied (``cp.async.bulk``) into an
  mbarrier ring of shared memory (csrc/gram.cu's note has the design).  X
  and w must start on a 16-byte boundary; a view that does not is copied
  first.
* p > 32, ``fm_wgram``: gram's 32×32 tile body (see gram.py), w multiplied
  into the left tile as the rows are staged.

Both add lanes, warps and splits in a fixed order: deterministic.
"""
from __future__ import annotations

import torch

from . import build, ref
from .common import LAUNCH_LOCK, aligned, route
from .gram import _DTYPES, check_x, tri_plan

#: Launches of the CUDA kernels (the plain CPU path does not count):
#: ``launches`` counts every call that launched, ``tri_launches`` those that
#: ran the triangle body (p ≤ 32).
launches = 0
tri_launches = 0


def wgram(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """G = XᵀWX for tall (n, p) X and per-row weights w (n,) or (n, 1);
    (p, p) float32."""
    global launches, tri_launches
    check_x(x, "wgram")
    n, p = x.shape
    if w.numel() != n or (w.ndim == 2 and w.shape[1] != 1) or w.ndim > 2:
        raise ValueError(f"wgram: w must be (n,) or (n, 1) with n={n}, "
                         f"got {tuple(w.shape)}")
    if not w.is_floating_point():
        raise TypeError(f"wgram: w must be floating, got {w.dtype}")
    if route(x, w) == "cpu":
        return ref.wgram_ref(x, w)
    x = x.contiguous()
    w = w.reshape(-1).to(torch.float32).contiguous()
    plan = tri_plan(n, p, x.dtype, weighted=True)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((p, p), dtype=torch.float32, device=x.device)
    lib = build.load("gram")
    stream = build.stream_handle(x)
    if plan.body == "tri":
        x, w = aligned(x), aligned(w)
        err = lib.fm_wgram_tri(x.data_ptr(), w.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), n, p, plan.chunk_rows,
                               plan.stages, plan.rows_per_split, plan.splits,
                               _DTYPES[x.dtype], stream)
    else:
        err = lib.fm_wgram(x.data_ptr(), w.data_ptr(), ws.data_ptr(),
                           out.data_ptr(), n, p, plan.splits,
                           _DTYPES[x.dtype], stream)
    build.check(err, "wgram")
    with LAUNCH_LOCK:
        launches += 1
        tri_launches += plan.body == "tri"
    return out
