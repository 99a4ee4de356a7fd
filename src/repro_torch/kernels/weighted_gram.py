"""Weighted Gram kernel G = XᵀWX on Hopper (csrc/gram.cu, ``fm_wgram``).

Replaces repro/kernels/weighted_gram.py:wgram (Pallas, `_wgram_kernel`), the
IRLS hot spot.  Same design and bound as `gram` (see gram.py): the weight of
a row multiplies the left tile as the row is staged into shared memory, so
the reweighted rows exist only there.  w adds n·4 bytes to the 8.4 GB read.
"""
from __future__ import annotations

import torch

from . import build, ref
from .common import route
from .gram import _DTYPES, TILE, check_x, gram_splits

#: Launches of the CUDA kernel (the plain CPU path does not count).
launches = 0


def wgram(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """G = XᵀWX for tall (n, p) X and per-row weights w (n,) or (n, 1);
    (p, p) float32."""
    global launches
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
    tiles = -(-p // TILE)
    splits = gram_splits(n, p)
    ws = torch.empty(splits * tiles * tiles * TILE * TILE, dtype=torch.float32,
                     device=x.device)
    out = torch.empty((p, p), dtype=torch.float32, device=x.device)
    lib = build.load("gram")
    err = lib.fm_wgram(x.data_ptr(), w.data_ptr(), ws.data_ptr(),
                       out.data_ptr(), n, p, splits, _DTYPES[x.dtype],
                       build.stream_handle(x))
    build.check(err, "wgram")
    launches += 1
    return out
