"""Tall-and-skinny SVD (paper §IV-A); PyTorch port of repro.algorithms.svd.

"To compute SVD on an n×p matrix A (n >> p), we first compute Gramian matrix
AᵀA and compute eigenvalues and eigenvectors to derive singular values and
singular vectors of the matrix A."

The Gram matrix is one streaming sink (the cuda backend lowers it onto
``kernels.gram``); the p×p eigendecomposition runs on the host in float64;
the left singular vectors U = A V Σ⁻¹ are an optional second pass (a fusable
tall·small inner product).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import fm


@dataclasses.dataclass
class SVDResult:
    s: np.ndarray                 # singular values, descending
    V: np.ndarray                 # right singular vectors (p × k)
    U: Optional[fm.FM] = None     # left singular vectors (n × k), optional


def svd_tall(X: fm.FM, k: int = 10, *, compute_u: bool = False,
             mode: str = "auto", fuse: bool = True,
             gram: Optional[np.ndarray] = None) -> SVDResult:
    """``gram`` short-circuits the Gram pass with an already-materialized
    XᵀX (pca co-materializes it with the column moments in one call)."""
    n, p = X.shape
    k = min(k, p)
    if gram is None:
        (G,) = fm.materialize(fm.crossprod(X), mode=mode, fuse=fuse)
        g = fm.as_np(G).astype(np.float64)
    else:
        g = np.asarray(gram, np.float64)
    evals, evecs = np.linalg.eigh(g)          # ascending
    evals = np.maximum(evals[::-1], 0.0)      # descending, clipped
    evecs = evecs[:, ::-1]
    s = np.sqrt(evals[:k])
    V = evecs[:, :k]
    U = None
    if compute_u:
        inv_s = np.where(s > 0, 1.0 / np.maximum(s, 1e-300), 0.0)
        # U = X @ (V Σ⁻¹): a row-local tall·small product.
        W = (V * inv_s.reshape(1, -1)).astype(np.float32)
        (U,) = fm.materialize(fm.inner_prod(X, W), mode=mode, fuse=fuse)
    return SVDResult(s=s, V=V, U=U)
