"""Pair-wise Pearson correlation (paper §IV-A); PyTorch port of
repro.algorithms.correlation.

    corr(X)_jk = (E[x_j x_k] - μ_j μ_k) / (σ_j σ_k)

The paper notes its implementation "requires an additional pass on the input
matrix to compute column-wise mean values, which results in lower
external-memory performance" (§IV-C).  Because our sinks co-materialize, the
single-pass moment form is the default here: Gram matrix, column sums and
column sums-of-squares all stream in ONE pass (a beyond-paper fix the DAG
makes free).  ``two_pass=True`` reproduces the paper-faithful variant for
the benchmark comparison.

Complexity: O(n·p²) compute, O(n·p) I/O (Table IV row 2).
"""
from __future__ import annotations

import numpy as np

from ..core import fm


def correlation(X: fm.FM, *, mode: str = "auto", fuse: bool = True,
                two_pass: bool = False) -> np.ndarray:
    n = X.nrow
    if two_pass:
        # Paper-faithful: pass 1 for means, pass 2 for the centered Gram.
        (sums,) = fm.materialize(fm.colSums(X), mode=mode, fuse=fuse)
        mu = fm.as_np(sums).reshape(-1) / n
        Zc = fm.mapply_row(X, mu, "sub")
        G = fm.crossprod(Zc)
        (Gm,) = fm.materialize(G, mode=mode, fuse=fuse)
        cov = fm.as_np(Gm) / (n - 1)
        sd = np.sqrt(np.diag(cov))
        return cov / np.outer(sd, sd)

    # Single-pass moment form: one fused scan produces all three sinks.
    G = fm.crossprod(X)
    sums = fm.colSums(X)
    (Gm, sm) = fm.materialize(G, sums, mode=mode, fuse=fuse)
    g = fm.as_np(Gm).astype(np.float64)
    s = fm.as_np(sm).reshape(-1).astype(np.float64)
    mu = s / n
    cov = (g - n * np.outer(mu, mu)) / (n - 1)
    sd = np.sqrt(np.diag(cov))
    return (cov / np.outer(sd, sd)).astype(np.float64)
