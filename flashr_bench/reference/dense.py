"""Plain reference of the algorithms over a tall dense matrix, in plain
PyTorch, a block of rows at a time so that it fits beside the data.

It imports nothing of the program: each function works out from the raw
inputs what the program's call of the same name returns, by the
textbook definition (column statistics, Pearson correlation, logistic
IRLS, Lloyd's k-means from k-means++ on a 16,384-row subsample).  Every
product goes through ``prec``, so the same code gives the reference
(float64) and the control (TF32 operands).
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import Precision

#: Rows a block: 4 Mi rows of 32 float64 values are 1 GiB.
BLOCK = 1 << 22

#: The IRLS weight floor that the GLM's definition adds to mu (1 - mu).
W_EPS = 1e-6

#: Rows of the subsample k-means++ draws its initial centres from.
KMEANS_SAMPLE = 16384


def blocks(n: int, rows: int = BLOCK):
    for s in range(0, n, rows):
        yield s, min(n, s + rows)


def column_stats(x: torch.Tensor, prec: Precision) -> dict:
    """Column min, max, non-zero count (exact), and the sums of x, |x| and
    x² as column sums, i.e. a row of ones times the block."""
    n, p = x.shape
    s = torch.zeros(p, dtype=prec.dtype, device=x.device)
    a, q = torch.zeros_like(s), torch.zeros_like(s)
    mn = torch.full((p,), float("inf"), device=x.device)
    mx = torch.full((p,), float("-inf"), device=x.device)
    nnz = torch.zeros(p, dtype=torch.int64, device=x.device)
    for b0, b1 in blocks(n):
        xb = x[b0:b1]
        mn = torch.minimum(mn, xb.amin(0))
        mx = torch.maximum(mx, xb.amax(0))
        nnz += (xb != 0).sum(0)
        one = torch.ones((1, b1 - b0), dtype=prec.dtype, device=x.device)
        xo = prec.operand(xb)
        s += (one @ xo)[0]
        a += (one @ xo.abs())[0]
        q += (one @ (xo * xo))[0]
    return {"min": mn, "max": mx, "nnz": nnz, "sum": s, "abs": a, "sq": q}


def summary(x: torch.Tensor, prec: Precision) -> dict:
    n = x.shape[0]
    st = column_stats(x, prec)
    mean = st["sum"] / n
    var = (st["sq"] - n * mean * mean) / (n - 1)
    return {"min": st["min"], "max": st["max"], "nnz": st["nnz"],
            "mean": mean, "l1": st["abs"], "l2": st["sq"].sqrt(), "var": var}


def gram(x: torch.Tensor, prec: Precision, w=None) -> torch.Tensor:
    """XᵀX, or XᵀWX with row weights ``w``, a block at a time."""
    p = x.shape[1]
    g = torch.zeros((p, p), dtype=prec.dtype, device=x.device)
    for b0, b1 in blocks(x.shape[0]):
        xb = prec.cast(x[b0:b1])
        xw = xb if w is None else xb * w[b0:b1, None]
        g += prec.mm(xw.T, xb)
    return g


def xty(x: torch.Tensor, v: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Xᵀv for a column v, a block at a time."""
    out = torch.zeros((x.shape[1], 1), dtype=prec.dtype, device=x.device)
    for b0, b1 in blocks(x.shape[0]):
        out += prec.mm(x[b0:b1].T, v[b0:b1].reshape(-1, 1))
    return out


def correlation(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    n = x.shape[0]
    g = gram(x, prec)
    mu = column_stats(x, prec)["sum"] / n
    cov = (g - n * torch.outer(mu, mu)) / (n - 1)
    sd = cov.diagonal().sqrt()
    return cov / torch.outer(sd, sd)


def _softplus(eta):
    return eta.clamp_min(0) + torch.log1p(torch.exp(-eta.abs()))


def glm_logistic(x: torch.Tensor, y: torch.Tensor, ridge: float,
                 iters: int, prec: Precision) -> dict:
    """Logistic regression by IRLS from beta = 0, ``iters`` Newton steps:
    each step's log-likelihood is taken at the beta it starts from, as the
    program's trace is."""
    n, p = x.shape
    beta = torch.zeros((p, 1), dtype=prec.dtype, device=x.device)
    trace = []
    for _ in range(iters):
        a = torch.zeros((p, p), dtype=prec.dtype, device=x.device)
        b = torch.zeros((p, 1), dtype=prec.dtype, device=x.device)
        ll = torch.zeros((), dtype=prec.dtype, device=x.device)
        for b0, b1 in blocks(n):
            xb = prec.cast(x[b0:b1])
            yb = prec.cast(y[b0:b1]).reshape(-1, 1)
            eta = prec.mm(xb, beta)
            mu = torch.sigmoid(eta)
            w = mu * (1 - mu) + W_EPS
            z = eta + (yb - mu) / w
            a += prec.mm((xb * w).T, xb)
            b += prec.mm(xb.T, w * z)
            ll += (yb * eta - _softplus(eta)).sum()
        trace.append(float(ll))
        eye = torch.eye(p, dtype=prec.dtype, device=x.device)
        beta = torch.linalg.solve(a + ridge * eye, b)
    return {"beta": beta.reshape(-1), "trace": trace}


def logistic_score(x, y, beta, ridge, prec: Precision) -> dict:
    """At ``beta``: the penalised score Xᵀ(y - mu) - ridge·beta and the
    diagonal of XᵀWX, in ``prec``."""
    n, p = x.shape
    g = torch.zeros(p, dtype=prec.dtype, device=x.device)
    h = torch.zeros(p, dtype=prec.dtype, device=x.device)
    bt = prec.cast(beta).reshape(-1, 1)
    for b0, b1 in blocks(n):
        xb = prec.cast(x[b0:b1])
        yb = prec.cast(y[b0:b1]).reshape(-1, 1)
        mu = torch.sigmoid(prec.mm(xb, bt))
        g += prec.mm(xb.T, yb - mu)[:, 0]
        h += prec.mm((xb * xb).T, mu * (1 - mu))[:, 0]
    return {"score": g - ridge * bt[:, 0], "hdiag": h}


def kmeans_init(rows_of, n: int, k: int, seed: int) -> np.ndarray:
    """k-means++ on a uniform subsample of ``KMEANS_SAMPLE`` rows drawn with
    numpy's ``default_rng(seed)``: the first centre a uniform row of it,
    each next one drawn with probability ∝ the squared distance to the
    nearest centre so far.  ``rows_of(idx)`` gives rows as float64."""
    rng = np.random.default_rng(seed)
    m = min(n, KMEANS_SAMPLE)
    idx = np.sort(rng.choice(n, size=m, replace=False))
    s = rows_of(idx)
    centers = [s[rng.integers(m)]]
    d2 = ((s - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        prob = d2 / max(d2.sum(), 1e-300)
        centers.append(s[rng.choice(m, p=prob)])
        d2 = np.minimum(d2, ((s - centers[-1]) ** 2).sum(1))
    return np.stack(centers).astype(np.float32)


def sq_dist(xb: torch.Tensor, c: torch.Tensor, prec: Precision):
    """Squared distances of a block's rows to the centres, (rows, k)."""
    xb = prec.cast(xb)
    c = prec.cast(c)
    return ((xb * xb).sum(1, keepdim=True) - 2 * prec.mm(xb, c.T)
            + (c * c).sum(1)[None, :])


def kmeans(x: torch.Tensor, init: np.ndarray, iters: int,
           prec: Precision) -> list:
    """Lloyd's iterations from ``init``; empty clusters keep their centre.
    Returns each step's labels and the centres it ends with."""
    n, p = x.shape
    k = init.shape[0]
    c = torch.as_tensor(init, device=x.device).to(prec.dtype)
    steps = []
    for _ in range(iters):
        sums = torch.zeros((k, p), dtype=prec.dtype, device=x.device)
        counts = torch.zeros(k, dtype=torch.int64, device=x.device)
        labels = torch.empty(n, dtype=torch.int32, device=x.device)
        for b0, b1 in blocks(n):
            lab = sq_dist(x[b0:b1], c, prec).argmin(1)
            labels[b0:b1] = lab
            sums.index_add_(0, lab, prec.cast(x[b0:b1]))
            counts += torch.bincount(lab, minlength=k)
        cnt = counts.to(prec.dtype)[:, None]
        c = torch.where(cnt > 0, sums / cnt.clamp_min(1), c)
        steps.append({"centers": c, "labels": labels})
    return steps


def label_gap(x: torch.Tensor, centers: torch.Tensor,
              labels: torch.Tensor) -> float:
    """The widest gap, in squared distance and float64, by which a row's
    given label lies farther than its nearest centre."""
    from .precision import REFERENCE
    worst = 0.0
    for b0, b1 in blocks(x.shape[0]):
        d = sq_dist(x[b0:b1], centers, REFERENCE)
        given = d.gather(1, labels[b0:b1].long().reshape(-1, 1))[:, 0]
        worst = max(worst, float((given - d.min(1).values).max()))
    return worst
