"""Naive Bayes classifiers (paper §IV-A) on GenOps; PyTorch port of
repro.algorithms.naive_bayes.

Training is the ``groupby.row`` showcase: every per-class moment is one
grouped sink, and all of them co-materialize in ONE pass over X; the
per-class means and variances are epilogue math over the merged sinks.

    cnt  <- table(y)                            # per-class counts   (sink)
    s1   <- rowsum(X, y)                        # per-class sums     (sink)
    s2   <- rowsum(X * X, y)                    # per-class sq-sums  (sink)
    mu   <- s1 / cnt;  var <- s2 / cnt - mu^2   # plan epilogue (lazy)

Multinomial NB (count features) takes per-class feature totals with Laplace
smoothing.  Prediction is one row-local pass: per-class log-likelihood
columns, cbind, which.max.  No kernel covers these patterns: they run the
generic rules on both backends, as they run XLA's in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import fm

_VAR_EPS = 1e-9


@dataclasses.dataclass
class NaiveBayesModel:
    kind: str                  # 'gaussian' | 'multinomial'
    class_log_prior: np.ndarray    # (k,)
    # gaussian: per-class means/variances; multinomial: log feature probs.
    means: np.ndarray | None       # (k, p)
    variances: np.ndarray | None   # (k, p)
    feature_log_prob: np.ndarray | None  # (k, p)
    class_count: np.ndarray        # (k,)


def nb_gaussian_outputs(X: fm.FM, y: fm.FM, k: int):
    """The gaussian training DAG as lazy handles: per-class counts plus the
    mu/var epilogue chains over the grouped sinks (one pass)."""
    cnt = fm.table_(y, k)
    s1 = fm.rowsum(X, y, k)
    s2 = fm.rowsum(X * X, y, k)
    safe = fm.pmax(fm.sapply(cnt, "cast_float32"), 1.0)
    mu = s1 / safe
    var = fm.pmax(s2 / safe - mu * mu, _VAR_EPS)
    return cnt, mu, var


def naive_bayes(X: fm.FM, y: fm.FM, num_classes: int, *,
                kind: str = "gaussian", alpha: float = 1.0,
                mode: str = "auto", fuse: bool = True,
                backend=None) -> NaiveBayesModel:
    """Train on an n×p matrix and a row-aligned n×1 integer label vector
    (0-based)."""
    n, p = X.shape
    k = int(num_classes)
    if kind == "gaussian":
        cnt, mu, var = nb_gaussian_outputs(X, y, k)
        cnt_m, mu_m, var_m = fm.materialize(
            cnt, mu, var, mode=mode, fuse=fuse, backend=backend)
        c = fm.as_np(cnt_m).reshape(-1).astype(np.float64)
        return NaiveBayesModel(
            kind=kind, class_log_prior=np.log(np.maximum(c, 1e-300) / n),
            means=fm.as_np(mu_m).astype(np.float64),
            variances=fm.as_np(var_m).astype(np.float64),
            feature_log_prob=None, class_count=c)
    if kind == "multinomial":
        cnt = fm.table_(y, k)
        Fc = fm.rowsum(X, y, k) + float(alpha)
        flp = fm.log(Fc) - fm.log(fm.rowSums(Fc))
        cnt_m, flp_m = fm.materialize(
            cnt, flp, mode=mode, fuse=fuse, backend=backend)
        c = fm.as_np(cnt_m).reshape(-1).astype(np.float64)
        return NaiveBayesModel(
            kind=kind, class_log_prior=np.log(np.maximum(c, 1e-300) / n),
            means=None, variances=None,
            feature_log_prob=fm.as_np(flp_m).astype(np.float64),
            class_count=c)
    raise ValueError(f"unknown kind {kind!r}; have gaussian|multinomial")


def nb_score(model: NaiveBayesModel, X: fm.FM) -> fm.FM:
    """Per-class log-likelihood columns (n × k, a lazy row-local chain)."""
    k = model.class_count.shape[0]
    if model.kind != "gaussian":
        # scores = X %*% t(log P) + log prior.
        W = model.feature_log_prob.astype(np.float32).T      # p × k
        return fm.mapply_row(X @ W,
                             model.class_log_prior.astype(np.float32), "add")
    cols = []
    for j in range(k):
        mu = model.means[j].astype(np.float32)
        var = model.variances[j].astype(np.float32)
        Z = fm.mapply_row(X, mu, "sub")
        q = fm.rowSums(fm.mapply_row(Z * Z, 2.0 * var, "div"))
        const = float(model.class_log_prior[j]
                      - 0.5 * np.log(2.0 * np.pi * model.variances[j]).sum())
        cols.append(const - q)
    return fm.cbind(*cols)


def nb_predict(model: NaiveBayesModel, X: fm.FM, *, mode: str = "auto",
               fuse: bool = True, backend=None) -> fm.FM:
    """Predicted class labels (n × 1, int32), one fused row-local pass."""
    labels = fm.which_max_row(nb_score(model, X))
    (out,) = fm.materialize(labels, mode=mode, fuse=fuse, backend=backend)
    return out
