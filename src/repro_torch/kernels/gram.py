"""Tall-skinny Gram kernel G = XᵀX on Hopper (csrc/gram.cu).

Replaces repro/kernels/gram.py:gram (Pallas, `_gram_kernel`).  Bound on an
H100 at the main path's 65,608,366 × 32 f32: reading X is 8.4 GB, about
2.5 ms at 3.35 TB/s, and 2np² = 1.34e11 FLOP is about 2.0 ms at the
67 TFLOP/s non-tensor f32 rate — the two are close, so the kernel has to
stream rows at full bandwidth AND keep the FMA pipes busy.  The design:
32×32 output tiles × a row split over ~4 blocks per SM, rows staged through
shared memory, a 4×4 register tile per thread (two 16-byte shared loads feed
16 FMAs), per-block partials to a workspace, and a second launch that sums
them in a fixed order (deterministic).  Full f32 FMA; no TF32, no tensor
cores (the reference tests hold f32 at 1e-4).
"""
from __future__ import annotations

import torch

from . import build, ref
from .common import route, splits_for

TILE = 32
#: Launches of the CUDA kernel (the plain CPU path does not count).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_x(x: torch.Tensor, what: str):
    if x.ndim != 2:
        raise ValueError(f"{what}: X must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: X must be float32 or bfloat16, got {x.dtype}")


def gram_splits(n: int, p: int) -> int:
    tiles = -(-p // TILE)
    return splits_for(n, 256, tiles * tiles)


def gram(x: torch.Tensor) -> torch.Tensor:
    """G = XᵀX for tall (n, p) X (float32 or bfloat16); (p, p) float32."""
    global launches
    check_x(x, "gram")
    if route(x) == "cpu":
        return ref.gram_ref(x)
    x = x.contiguous()
    n, p = x.shape
    tiles = -(-p // TILE)
    splits = gram_splits(n, p)
    ws = torch.empty(splits * tiles * tiles * TILE * TILE, dtype=torch.float32,
                     device=x.device)
    out = torch.empty((p, p), dtype=torch.float32, device=x.device)
    lib = build.load("gram")
    err = lib.fm_gram(x.data_ptr(), ws.data_ptr(), out.data_ptr(), n, p, splits,
                      _DTYPES[x.dtype], build.stream_handle(x))
    build.check(err, "gram")
    launches += 1
    return out
