"""Multivariate statistical summary (paper §IV-A); PyTorch port of
repro.algorithms.summary.

Column-wise min, max, mean, L1 norm, L2 norm, number of non-zero values and
variance — all eight sinks materialize together in ONE fused pass over the
data matrix, the paper's flagship demonstration of sink co-materialization
(complexity: O(n·p) compute, O(n·p) I/O, Table IV row 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import fm


@dataclasses.dataclass
class Summary:
    col_min: np.ndarray
    col_max: np.ndarray
    mean: np.ndarray
    l1: np.ndarray
    l2: np.ndarray
    nnz: np.ndarray
    var: np.ndarray


def summary(X: fm.FM, *, mode: str = "auto", fuse: bool = True) -> Summary:
    n = X.nrow
    mins = fm.colMins(X)
    maxs = fm.colMaxs(X)
    sums = fm.colSums(X)
    l1 = fm.colSums(fm.abs_(X))
    sq = fm.colSums(X ** 2)
    nnz = fm.agg_col(X, "count_nonzero")
    outs = fm.materialize(mins, maxs, sums, l1, sq, nnz, mode=mode, fuse=fuse)
    mn, mx, s, a1, s2, nz = [fm.as_np(o).reshape(-1) for o in outs]
    mean = s / n
    var = (s2 - n * mean ** 2) / (n - 1)
    return Summary(mn, mx, mean, a1, np.sqrt(s2), nz, var)
