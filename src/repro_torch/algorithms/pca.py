"""Principal component analysis (paper §IV-A) on GenOps; PyTorch port of
repro.algorithms.pca.

X is centered (and optionally scaled) lazily and the covariance Gram of the
VIRTUAL standardized matrix is computed: Z never exists as a result, and the
program — moment sinks, epilogue math, sweep and Gram contraction — is ONE
``fm.materialize`` call that the planner schedules as moment pass →
sweep+Gram pass (``exec_stats()['passes'] == 2``).  On the cuda backend the
moment pass runs ``kernels.fused_apply_agg``; the second pass's contraction
absorbs the sweep and runs the generic rules, as in the reference.

    Z  <- scale(X, scale = FALSE)          # lazy sweep over colMeans
    ev <- eigen(crossprod(Z) / (n - 1))    # two scheduled passes + small tier
    scores <- Z %*% ev$vectors[, 1:k]      # optional extra pass
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import fm
from .svd import svd_tall


@dataclasses.dataclass
class PCAResult:
    sdev: np.ndarray              # component standard deviations (k,)
    rotation: np.ndarray          # principal axes (p × k)
    center: np.ndarray            # column means used for centering (p,)
    scale: Optional[np.ndarray]   # column sds when scale=True, else None
    scores: Optional[fm.FM]       # n × k projections (optional)


def pca(X: fm.FM, k: int = 10, *, center: bool = True, scale: bool = False,
        compute_scores: bool = False, mode: str = "auto",
        fuse: bool = True) -> PCAResult:
    """R prcomp(): PCA of a tall (n, p) matrix.  ``scale=True`` standardizes
    the columns (correlation PCA)."""
    n, p = X.shape
    k = min(k, p)
    mu = np.zeros(p, np.float32)
    sd = None
    Z = X
    wants = []
    if center:
        mu_fm = fm.colMeans(X)
        wants.append(mu_fm)
        Z = fm.mapply_row(Z, mu_fm, "sub")
    if scale:
        sd_fm = fm.colSds(X)
        wants.append(sd_fm)
        Z = fm.mapply_row(Z, fm.pmax(sd_fm, 1e-12), "div")
    # ONE materialize: Gram of the (virtual) centered matrix + the moments.
    outs = fm.materialize(fm.crossprod(Z), *wants, mode=mode, fuse=fuse)
    g = fm.as_np(outs[0]).astype(np.float64)
    if center:
        mu = fm.as_np(outs[1]).reshape(-1).astype(np.float32)
    if scale:
        sd = fm.as_np(outs[-1]).reshape(-1).astype(np.float32)
    # Scores reuse the now-physical moments: one sweep+product pass.
    Zp = X
    if center:
        Zp = fm.mapply_row(Zp, mu, "sub")
    if scale:
        Zp = fm.mapply_row(Zp, np.maximum(sd, 1e-12), "div")
    r = svd_tall(Zp, k=k, compute_u=compute_scores, mode=mode, fuse=fuse,
                 gram=g)
    sdev = r.s / np.sqrt(max(n - 1, 1))
    scores = None
    if compute_scores:
        # U·Σ = Z·V: rescale the left singular vectors.
        scores = fm.mapply_row(r.U, r.s.astype(np.float32), "mul")
        (scores,) = fm.materialize(scores, mode=mode, fuse=fuse)
    return PCAResult(sdev=sdev, rotation=r.V, center=mu, scale=sd,
                     scores=scores)
