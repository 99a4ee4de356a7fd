"""K-means (Lloyd's algorithm, paper §IV-A) on GenOps; PyTorch port of
repro.algorithms.kmeans.

One iteration is ONE fused pass over X:

    D      = fm.inner.prod(X, t(C), squared_diff, sum)   # distances (fusable)
    labels = fm.agg.row(D, which.min)                    # assignment (fusable)
    sums   = fm.groupby.row(X, labels, sum)              # sink
    counts = fm.groupby.row(1, labels, count)            # sink
    wss    = fm.agg(min-distance, sum)                   # sink (objective)

The cuda backend lowers the whole group onto the ``kmeans_assign`` kernel.
Initialization is k-means++ with a numpy RNG, as in the reference, so the
same seed gives the same initial centers in both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import fm


@dataclasses.dataclass
class KMeansResult:
    centers: np.ndarray
    labels: fm.FM          # n-vector on the engine's device
    wss: float             # within-cluster sum of squares (objective)
    iters: int


def _rows(data, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of a matrix's data (a device tensor or a host numpy
    array) as a float64 numpy array."""
    if isinstance(data, np.ndarray):
        return np.asarray(data[idx], dtype=np.float64)
    rows = data[torch.as_tensor(idx, device=data.device)]
    return rows.to(torch.float32).cpu().numpy().astype(np.float64)


def _init_centers(X: fm.FM, k: int, seed: int) -> np.ndarray:
    """k-means++ on a uniform row subsample (≤16k rows), on the host."""
    rng = np.random.default_rng(seed)
    n = X.nrow
    m = min(n, 16384)
    idx = np.sort(rng.choice(n, size=m, replace=False))
    S = _rows(X.m.logical_data(), idx)
    centers = [S[rng.integers(m)]]
    d2 = ((S - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        prob = d2 / max(d2.sum(), 1e-300)
        centers.append(S[rng.choice(m, p=prob)])
        d2 = np.minimum(d2, ((S - centers[-1]) ** 2).sum(1))
    return np.stack(centers).astype(np.float32)


def kmeans_iteration(X: fm.FM, centers: np.ndarray, *, mode: str = "auto",
                     fuse: bool = True):
    """One Lloyd step: returns (new_centers, counts, wss, labels_FM)."""
    k = centers.shape[0]
    D = fm.inner_prod(X, centers.T, "squared_diff", "sum")   # n×k distances
    labels = fm.which_min_row(D)                             # n×1, fusable
    mind = fm.rowMins(D)                                     # n×1, fusable
    sums = fm.rowsum(X, labels, k)                           # k×p sink
    counts = fm.table_(labels, k)                            # k×1 sink
    wss = fm.sum_(mind)                                      # scalar sink
    sums_m, counts_m, wss_m, labels_m = fm.materialize(
        sums, counts, wss, labels, mode=mode, fuse=fuse)
    s = fm.as_np(sums_m)
    c = fm.as_np(counts_m).reshape(-1).astype(np.float64)
    # Empty clusters keep their previous center (mclust/MLlib convention).
    new_centers = np.where(c.reshape(-1, 1) > 0,
                           s / np.maximum(c.reshape(-1, 1), 1.0),
                           centers).astype(np.float32)
    return new_centers, c, float(fm.as_scalar(wss_m)), labels_m


def kmeans(X: fm.FM, k: int = 10, *, max_iter: int = 20, tol: float = 1e-6,
           seed: int = 0, mode: str = "auto", fuse: bool = True,
           inspect: bool = True) -> KMeansResult:
    """Lloyd iterations until the objective stops improving by ``tol``
    (relative) or ``max_iter``; ``inspect=True`` declares the loop to the
    executor (``fm.inspect_iterations``)."""
    centers = _init_centers(X, k, seed)
    prev_wss = np.inf
    labels = None
    wss = np.inf
    it = 0
    scope = (fm.inspect_iterations() if inspect
             else contextlib.nullcontext())
    with scope:
        for it in range(1, max_iter + 1):
            centers, counts, wss, labels = kmeans_iteration(
                X, centers, mode=mode, fuse=fuse)
            if (np.isfinite(prev_wss)
                    and prev_wss - wss <= tol * max(prev_wss, 1.0)):
                break
            prev_wss = wss
    return KMeansResult(centers=centers, labels=labels, wss=wss, iters=it)
