"""``summary(X)``: column min, max, mean, L1 and L2 norms, non-zero counts
and variance in one pass, over the call's own window of X's rows
(``_common.draw_window``: the same shape every call, other rows each
call).

Compared: min, max and the non-zero counts exactly, and the means in
standard errors.  The L1 and L2 norms and the variances are sums of
positive terms whose float32 rounding the control's TF32 operands do not
exceed (no upper reading, PERF.md), so they are not compared."""
from __future__ import annotations

import numpy as np

from flashr_bench.ops._common import draw_window, host, window
from flashr_bench.reference import dense

FIELDS = ("min", "max", "nnz", "mean", "l1", "l2", "var")


def work(cfg, sizes, params):
    n, p = cfg["rows"] - params["cut_rows"], cfg["cols"]
    return {"bytes": sizes["X"] // cfg["rows"] * n, "flops": 7 * n * p,
            "passes": 1}


def draw(spec, rng, ordinal):
    return draw_window(spec, ordinal)


def call(ctx, params):
    from repro_torch.algorithms import summary
    s = summary(ctx.fm.conv_R2FM(window(ctx.x, params)), mode=ctx.mode)
    return {"min": s.col_min, "max": s.col_max, "nnz": s.nnz, "mean": s.mean,
            "l1": s.l1, "l2": s.l2, "var": s.var}


def reference(ref, params, prec):
    return dense.summary(window(ref.x, params), prec)


def compare(ans, r, ref, params):
    n = ref.x.shape[0] - params["cut_rows"]
    exact = sum(int(np.sum(host(ans[k]) != host(r[k])))
                for k in ("min", "max", "nnz"))
    se = np.sqrt(host(r["var"]) / n)
    return {"summary.exact": exact,
            "summary.mean": float(np.max(np.abs(host(ans["mean"])
                                                - host(r["mean"])) / se))}
