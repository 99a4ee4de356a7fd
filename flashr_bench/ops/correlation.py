"""``correlation(X)``: the Pearson correlation matrix, its Gram and column
sums in one pass, over the call's own window of X's rows
(``_common.draw_window``)."""
from __future__ import annotations

import numpy as np

from flashr_bench.ops._common import draw_window, host, window
from flashr_bench.reference import dense


def work(cfg, sizes, params):
    n, p = cfg["rows"] - params["cut_rows"], cfg["cols"]
    return {"bytes": sizes["X"] // cfg["rows"] * n, "flops": n * p * (p + 2),
            "passes": 1}


def draw(spec, rng, ordinal):
    return draw_window(spec, ordinal)


def call(ctx, params):
    from repro_torch.algorithms import correlation
    return {"corr": correlation(ctx.fm.conv_R2FM(window(ctx.x, params)),
                                mode=ctx.mode)}


def reference(ref, params, prec):
    return {"corr": dense.correlation(window(ref.x, params), prec)}


def compare(ans, r, ref, params):
    return {"correlation.err": float(np.max(np.abs(host(ans["corr"])
                                                   - host(r["corr"]))))}
