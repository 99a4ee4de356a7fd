"""Generalized linear models via IRLS (paper §IV-A's logistic regression,
generalized to the gaussian/logistic/poisson families) on GenOps; PyTorch
port of repro.algorithms.glm.

Every IRLS iteration is ONE fused plan over X: the weighted Gram XᵀWX, the
weighted moment XᵀWz and the log-likelihood sink co-materialize while a
partition is resident in the fast tier, and the p×p Newton solve runs as a
lazy EPILOGUE op in the SAME plan — one launch after the partial merge, on
device, so the whole R expression below executes as a single DAG.  The
weighted-Gram segment (``mapply.col(X, w, mul) → inner.prod(mul, sum)``)
is the pattern the cuda backend lowers onto ``kernels/weighted_gram.py``.

Equivalent FlashR R code (paper Fig. 4 style):

    eta <- X %*% beta
    mu  <- 1 / (1 + exp(-eta))                 # logistic link inverse
    w   <- mu * (1 - mu)
    z   <- eta + (y - mu) / w                  # working response
    XtWX <- crossprod(X * w, X)                # weighted Gram  (sink)
    XtWz <- crossprod(X, w * z)                # weighted moment (sink)
    ll   <- sum(y * eta - log(1 + exp(eta)))   # log-likelihood (sink)
    beta <- solve(XtWX, XtWz)                  # plan epilogue

Complexity per iteration: O(n·p²) compute, O(n·p) I/O — the correlation/SVD
row of Table IV, with the same out-of-core behavior.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import fm
from ..core.fusion import Plan

FAMILIES = ("gaussian", "logistic", "poisson")

#: Weight floor: keeps the working response finite when mu saturates.
_W_EPS = 1e-6

#: Column-sd floor for feature standardization (constant columns).
_SD_EPS = 1e-12


@dataclasses.dataclass
class GLMResult:
    beta: np.ndarray        # (p,) coefficients (float64)
    family: str
    loglik: float           # final log-likelihood (gaussian: -0.5·RSS)
    loglik_trace: list
    iters: int
    converged: bool
    # Feature standardization (glm(standardize=True)): beta is on the
    # STANDARDIZED scale; glm_predict applies the same sweep.
    center: "np.ndarray | None" = None   # column means, (p,)
    scale: "np.ndarray | None" = None    # column sds (floored), (p,)


def _softplus(eta: fm.FM) -> fm.FM:
    """log(1 + exp(eta)), overflow-safe: max(eta, 0) + log1p(exp(-|eta|))."""
    return fm.pmax(eta, 0.0) + fm.log1p(fm.exp(-fm.abs_(eta)))


def glm_irls_sinks(X: fm.FM, y: fm.FM, beta: np.ndarray, family: str):
    """The three sinks of one IRLS iteration (all lazy; co-materialize for
    one fused pass over X): XᵀWX, XᵀWz, log-likelihood.

    ``beta`` may be a host array OR the previous iteration's device-resident
    epilogue output (the Newton solve result): forwarding the device value
    keeps iteration i's epilogue feeding iteration i+1's pass as a broadcast
    binding with no host roundtrip — and since small operands sign the plan
    by shape/dtype only, the plan cache still hits."""
    if isinstance(beta, torch.Tensor):
        b = beta.reshape(-1, 1).to(torch.float32)
    else:
        b = np.asarray(beta, np.float32).reshape(-1, 1)
    eta = X @ b                                   # n×1, row-local
    if family == "gaussian":
        # Constant unit weights: IRLS is ordinary least squares, one step.
        # The sink is the RSS at the pre-step coefficients; glm() finishes
        # −RSS(β_new)/2 via the quadratic expansion on the small tier.
        w = y * 0.0 + 1.0
        z = y
        ll = fm.sum_((y - eta) ** 2)
    elif family == "logistic":
        mu = fm.sigmoid(eta)
        w = mu * (1.0 - mu) + _W_EPS
        z = eta + (y - mu) / w
        ll = fm.sum_(y * eta - _softplus(eta))
    elif family == "poisson":
        mu = fm.exp(eta)
        w = mu + _W_EPS
        z = eta + (y - mu) / w
        ll = fm.sum_(y * eta - mu)
    else:
        raise ValueError(f"unknown family {family!r}; have {FAMILIES}")
    Xw = fm.mapply_col(X, w, "mul")               # X ⊙ w, row-local
    XtWX = fm.crossprod(Xw, X)                    # p×p weighted Gram sink
    XtWz = fm.crossprod(X, w * z)                 # p×1 weighted moment sink
    return XtWX, XtWz, ll


def glm_irls_outputs(X: fm.FM, y: fm.FM, beta: np.ndarray, family: str,
                     ridge: float = 0.0):
    """One WHOLE IRLS iteration as a single lazy DAG: the three sinks plus
    ``beta_next = solve(XᵀWX (+ ridge·I), XᵀWz)`` running in the plan
    epilogue — the Newton step materializes in the same fused pass over X.
    Returns (beta_next, ll, XtWX, XtWz) lazy handles."""
    XtWX, XtWz, ll = glm_irls_sinks(X, y, beta, family)
    A = XtWX
    if ridge:
        # The ridge eye matrix is an epilogue-only source: handed whole to
        # the post-merge callable, never streamed.
        A = A + fm.conv_R2FM((ridge * np.eye(X.ncol)).astype(np.float32))
    beta_next = fm.solve(A, XtWz)
    return beta_next, ll, XtWX, XtWz


def glm_iteration_plan(X: fm.FM, y: fm.FM, beta: np.ndarray,
                       family: str) -> Plan:
    """The fusion Plan of one IRLS iteration, INCLUDING the epilogue Newton
    solve — exposes the cost counters (bytes_in vs nbytes(X): the proof
    each iteration streams X once) and the epilogue stage evidence."""
    beta_next, ll, _, _ = glm_irls_outputs(X, y, beta, family)
    return Plan([beta_next.m, ll.m])


def glm(X: fm.FM, y: fm.FM, family: str = "logistic", *, max_iter: int = 25,
        tol: float = 1e-8, ridge: float = 0.0, mode: str = "auto",
        fuse: bool = True, backend=None, standardize: bool = False,
        inspect: bool = True) -> GLMResult:
    """Fit a GLM by iteratively reweighted least squares.

    ``X``: n×p design matrix on the engine's device.
    ``y``: n×1 response, row-aligned with X (0/1 for logistic, counts for
    poisson).  ``ridge`` adds an L2 penalty to the normal equations (also
    the numerical-rescue knob for separable logistic data).

    ``standardize=True`` fits on lazily standardized features: the FIRST
    iteration is a single-materialize TWO-PASS plan — the column moments
    stream in pass 1 and the standardized IRLS sinks + Newton solve in
    pass 2 (``exec_stats()['passes'] == 2``) — and later iterations reuse
    the now-physical moments as one-pass plans.  ``result.beta`` is on the
    standardized scale (``result.center``/``result.scale`` record the
    sweep; ``glm_predict`` applies it).

    ``inspect=True`` (default) declares the IRLS loop to the executor
    (``fm.inspect_iterations``): the converged beta of iteration i feeds
    iteration i+1's pass directly from the device (no host roundtrip), and
    consecutive iterations' streams reuse the resident final partition of
    X instead of re-reading it (``prefetch_reuse_hits``).
    """
    n, p = X.shape
    beta = np.zeros(p, np.float64)
    # The value iteration i+1's sinks bind: starts as the host zeros, then
    # (under inspect) the device-resident epilogue output of iteration i.
    beta_carry: object = beta
    trace: list[float] = []
    prev = -np.inf
    converged = False
    it = 0
    center = scale_v = None
    if standardize:
        # Pure lazy standardization chain: materializes WITH iteration 1.
        mu_fm, sd_fm = fm.colMeans(X), fm.colSds(X)
        Z = fm.mapply_row(fm.mapply_row(X, mu_fm, "sub"),
                          fm.pmax(sd_fm, _SD_EPS), "div")
    else:
        Z = X
    scope = (fm.inspect_iterations() if inspect
             else contextlib.nullcontext())
    with scope:
      for it in range(1, max_iter + 1):
        # The ENTIRE iteration — sinks and the epilogue Newton solve — is
        # one plan: a single streaming pass over X and one epilogue launch
        # (plus the one-off moment pass when standardizing, iteration 1).
        beta_fm, ll_fm, XtWX_fm, XtWz_fm = glm_irls_outputs(
            Z, y, beta_carry, family, ridge)
        moment_wants = ([mu_fm, sd_fm]
                        if standardize and center is None else [])
        if family == "gaussian":
            # Also pull the (unridged) normal-equation sinks: the quadratic
            # RSS expansion below needs them on the small tier.
            beta_m, ll_m, A_m, b_m, *mo = fm.materialize(
                beta_fm, ll_fm, XtWX_fm, XtWz_fm, *moment_wants, mode=mode,
                fuse=fuse, backend=backend)
        else:
            beta_m, ll_m, *mo = fm.materialize(
                beta_fm, ll_fm, *moment_wants, mode=mode, fuse=fuse,
                backend=backend)
        if moment_wants:
            # Rebind the sweep to the physical moments: iterations 2+ are
            # ordinary one-pass plans over X.
            center = fm.as_np(mo[0]).reshape(-1).astype(np.float32)
            scale_v = np.maximum(
                fm.as_np(mo[1]).reshape(-1).astype(np.float32), _SD_EPS)
            Z = fm.mapply_row(fm.mapply_row(X, center, "sub"),
                              scale_v, "div")
        beta = fm.as_np(beta_m).astype(np.float64).reshape(-1)
        # Forward the device value: iteration i's epilogue result becomes
        # iteration i+1's broadcast binding without leaving the device.
        beta_carry = (beta_m.m.logical_data() if inspect else beta)
        if not np.isfinite(beta).all():
            # The on-device epilogue solve cannot raise like the old eager
            # float64 numpy path did — restore the diagnostic here.
            raise np.linalg.LinAlgError(
                f"IRLS normal equations are singular or too ill-conditioned "
                f"for the on-device solve at iteration {it} (family="
                f"{family!r}); add a ridge penalty (glm(..., ridge=...)) or "
                f"drop collinear columns")
        ll = float(fm.as_scalar(ll_m))
        if family == "gaussian":
            # The streamed sink is RSS at the pre-step coefficients — zeros
            # on this single OLS step, so it equals yᵀy.  Finish the
            # quadratic expansion at the new beta on the small tier:
            # RSS(β) = yᵀy − 2βᵀXᵀy + βᵀ(XᵀX)β.
            A0 = fm.as_np(A_m).astype(np.float64)
            bvec = fm.as_np(b_m).astype(np.float64).reshape(-1)
            rss = ll - 2.0 * float(bvec @ beta) + float(beta @ (A0 @ beta))
            trace.append(-0.5 * rss)
            converged = True        # constant weights: one Newton step
            break
        trace.append(ll)
        if np.isfinite(prev) and abs(ll - prev) <= tol * (abs(prev) + 1.0):
            converged = True
            break
        prev = ll
    return GLMResult(beta=beta, family=family, loglik=trace[-1],
                     loglik_trace=trace, iters=it, converged=converged,
                     center=center, scale=scale_v)


def glm_predict(result: GLMResult, X: fm.FM) -> fm.FM:
    """Linear predictor / response on the link scale: one row-local pass
    (lazy — fuses with downstream GenOps).  A standardized fit sweeps X
    with the training moments first (still row-local and lazy)."""
    if result.center is not None:
        X = fm.mapply_row(fm.mapply_row(X, result.center, "sub"),
                          result.scale, "div")
    eta = X @ result.beta.astype(np.float32).reshape(-1, 1)
    if result.family == "logistic":
        return fm.sigmoid(eta)
    if result.family == "poisson":
        return fm.exp(eta)
    return eta
