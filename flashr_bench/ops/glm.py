"""``glm(X, y, family="logistic", ridge=..., max_iter=...)``: logistic
regression by IRLS, run for exactly ``max_iter`` Newton steps (its
tolerance set below zero), each step one pass over X and y.

Compared: the log-likelihood of every step against the reference's.  The
coefficients are not compared: Newton's step corrects the rounding of the
predictor, and their float32 error is not exceeded by the control's TF32
operands (no upper reading, PERF.md)."""
from __future__ import annotations

import numpy as np

from flashr_bench.reference import dense


def work(cfg, sizes, params):
    n, p, it = cfg["rows"], cfg["cols"], params["max_iter"]
    return {"bytes": it * (sizes["X"] + sizes["y"]),
            "flops": it * n * (p * (p + 1) + 4 * p + 20), "passes": it}


def draw(spec, rng, ordinal):
    lo, hi = spec["ridge"]
    return {"family": spec["family"], "max_iter": spec["max_iter"],
            "ridge": float(rng.uniform(lo, hi))}


def call(ctx, params):
    from repro_torch.algorithms import glm
    res = glm(ctx.X, ctx.y, params["family"], max_iter=params["max_iter"],
              tol=-1.0, ridge=params["ridge"], mode=ctx.mode)
    if res.iters != params["max_iter"]:
        raise RuntimeError(f"glm ran {res.iters} iterations, not "
                           f"{params['max_iter']}")
    return {"trace": list(res.loglik_trace)}


def reference(ref, params, prec):
    out = dense.glm_logistic(ref.x, ref.y, params["ridge"],
                             params["max_iter"], prec)
    return {"trace": out["trace"]}


def compare(ans, r, ref, params):
    t, tr = np.asarray(ans["trace"], np.float64), np.asarray(r["trace"])
    return {"glm.trace": float(np.max(np.abs(t - tr) / np.abs(tr)))}
