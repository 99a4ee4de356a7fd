"""Gaussian Mixture Model via EM (paper §IV-A), full covariance, on GenOps;
PyTorch port of repro.algorithms.gmm.

One EM iteration is ONE fused pass over X.  For each component j:

    Z_j  = X - μ_j                        (mapply.row, fusable)
    Y_j  = Z_j L_j⁻ᵀ                      (inner.prod tall·small, fusable)
    q_j  = rowSums(Y_j²)                  (agg.row, fusable)
    ll_j = logπ_j - ½(p·log2π + logdet_j) - ½q_j
    r_j  = exp(ll_j - logsumexp_j ll_j)   (responsibilities, fusable)

and the sinks — N_j = Σᵢ r_ij, M_j = Xᵀ r_j (``kernels.xty`` on cuda),
S_j = (X ⊙ r_j)ᵀ X (``kernels.wgram``) and the total log-likelihood — all
co-materialize in that single pass.  In whole mode Z_j, Y_j and Y_j² are
full height; the step frees each after its last reader
(``LoweredProgram.release``).  The M-step is host math in float64 (k
Cholesky factorizations of p×p matrices).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..core import fm


@dataclasses.dataclass
class GMMResult:
    weights: np.ndarray     # (k,)
    means: np.ndarray       # (k, p)
    covs: np.ndarray        # (k, p, p)
    loglik: float
    loglik_trace: list
    iters: int


def _chol_factors(covs: np.ndarray):
    """Per-component (L⁻ᵀ, logdet) for the Mahalanobis inner product."""
    k, p, _ = covs.shape
    inv_lt = np.empty_like(covs)
    logdet = np.empty(k)
    for j in range(k):
        L = np.linalg.cholesky(covs[j])
        inv_lt[j] = np.linalg.inv(L).T      # rowSums((Z L⁻ᵀ)²) = quad form
        logdet[j] = 2.0 * np.log(np.diag(L)).sum()
    return inv_lt, logdet


def gmm_moment_outputs(X: fm.FM, weights, means, covs):
    """The E-step of one iteration as lazy sinks: [loglik, then (N_j, M_j,
    S_j) for each component] — one fused pass over X."""
    n, p = X.shape
    k = means.shape[0]
    inv_lt, logdet = _chol_factors(covs)
    const = -0.5 * p * math.log(2.0 * math.pi)
    lls = []
    for j in range(k):
        Z = fm.mapply_row(X, means[j].astype(np.float32), "sub")
        Y = fm.inner_prod(Z, inv_lt[j].astype(np.float32))
        q = fm.agg_row(Y ** 2, "sum")
        ll = q * (-0.5) + float(math.log(max(weights[j], 1e-300))
                                + const - 0.5 * logdet[j])
        lls.append(ll)
    LL = fm.cbind(*lls)                       # n×k, fusable
    lse = fm.agg_row(LL, "logsumexp")         # n×1, fusable
    sinks = [fm.sum_(lse)]                    # total log-likelihood
    for j in range(k):
        r_j = fm.exp(lls[j] - lse)            # responsibilities for j
        Xw = fm.mapply_col(X, r_j, "mul")
        sinks.extend([fm.sum_(r_j),           # N_j
                      fm.crossprod(X, r_j),   # M_j = Xᵀ r_j: p×1
                      fm.crossprod(Xw, X)])   # S_j = (X⊙r_j)ᵀX: p×p
    return sinks


def gmm_iteration(X: fm.FM, weights, means, covs, *, mode="auto", fuse=True):
    n, p = X.shape
    k = means.shape[0]
    outs = fm.materialize(*gmm_moment_outputs(X, weights, means, covs),
                          mode=mode, fuse=fuse)
    loglik = float(fm.as_scalar(outs[0]))
    new_w = np.empty(k)
    new_mu = np.empty((k, p))
    new_cov = np.empty((k, p, p))
    for j in range(k):
        Nk = float(fm.as_scalar(outs[1 + 3 * j]))
        Mk = fm.as_np(outs[2 + 3 * j]).reshape(-1).astype(np.float64)
        Sj = fm.as_np(outs[3 + 3 * j]).astype(np.float64)
        Nk = max(Nk, 1e-8)
        mu = Mk / Nk
        cov = Sj / Nk - np.outer(mu, mu)
        cov = 0.5 * (cov + cov.T) + 1e-6 * np.eye(p)
        new_w[j] = Nk / n
        new_mu[j] = mu
        new_cov[j] = cov
    new_w /= new_w.sum()
    return new_w, new_mu, new_cov, loglik


def gmm(X: fm.FM, k: int = 10, *, max_iter: int = 30, tol: float = 1e-5,
        seed: int = 0, mode: str = "auto", fuse: bool = True,
        inspect: bool = True) -> GMMResult:
    """EM until the log-likelihood stops rising by ``tol`` (relative) or
    ``max_iter``; the initial means are k rows drawn with a numpy RNG, as in
    the reference."""
    n, p = X.shape
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=k, replace=False))
    data = fm._fm(X).logical_data()
    rows = data[torch.as_tensor(idx, device=data.device)]
    means = rows.to(torch.float32).cpu().numpy().astype(np.float64)
    covs = np.tile(np.eye(p), (k, 1, 1))
    weights = np.full(k, 1.0 / k)

    trace = []
    prev = -np.inf
    it = 0
    scope = (fm.inspect_iterations() if inspect
             else contextlib.nullcontext())
    with scope:
        for it in range(1, max_iter + 1):
            weights, means, covs, loglik = gmm_iteration(
                X, weights, means, covs, mode=mode, fuse=fuse)
            trace.append(loglik)
            if loglik - prev <= tol * abs(max(prev, -1e300)) and it > 1:
                break
            prev = loglik
    return GMMResult(weights=weights, means=means, covs=covs,
                     loglik=trace[-1], loglik_trace=trace, iters=it)
