"""``kmeans(X, k, max_iter)``: Lloyd's iterations from k-means++ on a
16,384-row subsample drawn with the call's own seed, run for exactly
``max_iter`` iterations (its tolerance set below zero), each one pass.

Lloyd's trajectory on this data amplifies any rounding from step to step
(two float32 orders part by ~1e-2 in five steps), so no reference can
follow it from the seed.  So the reference follows the program's own state,
step by step.  After the window, ``stage`` calls the program's entry again
with the kept call's own parameters at ``max_iter`` = 1, 2, ..., and the
comparison holds:

- ``kmeans.rerun``: the last of these against the window's answer, entry
  for entry (an exact count of the centres and labels that differ): the
  steps checked are the steps the window ran;
- ``kmeans.label_gap``: each step's labels against the centres it started
  from (the k-means++ start, which the reference works out again, for the
  first step; the program's centres of the step before for the others), by
  the widest gap in squared distance between a row's label and its nearest
  centre (float64);
- ``kmeans.update``: each step's centres against the float64 means of the
  rows under that step's labels (clusters left empty keep their centre, and
  are skipped).
"""
from __future__ import annotations

import numpy as np
import torch

from flashr_bench.ops._common import device_tensor, host
from flashr_bench.reference import dense


def work(cfg, sizes, params):
    n, p, k = cfg["rows"], cfg["cols"], params["k"]
    it = params["max_iter"]
    return {"bytes": it * sizes["X"], "flops": it * n * p * (3 * k + 1),
            "passes": it}


def draw(spec, rng, ordinal):
    return {"k": spec["k"], "max_iter": spec["max_iter"],
            "seed": int(rng.integers(0, 2 ** 31))}


def _run(ctx, params, iters):
    from repro_torch.algorithms import kmeans
    res = kmeans(ctx.X, k=params["k"], max_iter=iters, tol=float("-inf"),
                 seed=params["seed"], mode=ctx.mode)
    if res.iters != iters:
        raise RuntimeError(f"kmeans ran {res.iters} iterations, not {iters}")
    return {"centers": np.asarray(res.centers),
            "labels": device_tensor(ctx.fm, res.labels, ctx.device)
            .reshape(-1)}


def call(ctx, params):
    return _run(ctx, params, params["max_iter"])


def stage(ctx, params):
    """The program's state after each step: the same call stopped after
    1, 2, ..., ``max_iter`` steps."""
    return {"steps": [_run(ctx, params, m)
                      for m in range(1, params["max_iter"] + 1)]}


def _init(x, params):
    def rows_of(idx):
        return x[torch.as_tensor(idx, device=x.device)].to(
            torch.float64).cpu().numpy()
    return dense.kmeans_init(rows_of, x.shape[0], params["k"],
                             params["seed"])


def reference(ref, params, prec):
    """The k-means++ start, worked out again from the inputs."""
    return {"init": _init(ref.x, params)}


def control(ref, params, prec):
    """The reference in ``prec``, in the program's place: its own Lloyd
    steps from the start, shaped as the program's answer and stages."""
    steps = dense.kmeans(ref.x, _init(ref.x, params), params["max_iter"],
                         prec)
    return {**steps[-1], "steps": steps}


def group_means(x, labels, k):
    """float64 means of the rows under each label, and the counts."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    for b0, b1 in dense.blocks(x.shape[0]):
        lab = labels[b0:b1].long()
        sums.index_add_(0, lab, x[b0:b1].to(torch.float64))
        counts += torch.bincount(lab, minlength=k)
    return sums / counts.clamp_min(1)[:, None], counts


def _differ(a, b) -> float:
    a, b = host(a), host(b)
    if a.shape != b.shape:
        return float("inf")
    return float(np.sum(a != b))


def compare(ans, r, ref, params):
    n, k = ref.x.shape[0], params["k"]
    steps = ans["steps"]
    if len(steps) != params["max_iter"]:
        inf = float("inf")
        return {"kmeans.rerun": inf, "kmeans.label_gap": inf,
                "kmeans.update": inf}
    last = steps[-1]
    out = {"kmeans.rerun": (_differ(last["centers"], ans["centers"])
                            + _differ(last["labels"], ans["labels"])),
           "kmeans.label_gap": 0.0, "kmeans.update": 0.0}
    start = torch.as_tensor(r["init"], device=ref.x.device)
    for st in steps:
        labels = st["labels"].to(ref.x.device)
        if labels.shape[0] != n:
            out["kmeans.label_gap"] = out["kmeans.update"] = float("inf")
            break
        out["kmeans.label_gap"] = max(out["kmeans.label_gap"],
                                      dense.label_gap(ref.x, start, labels))
        means, counts = group_means(ref.x, labels, k)
        full = host(counts) > 0
        out["kmeans.update"] = max(out["kmeans.update"], float(np.max(np.abs(
            host(st["centers"])[full] - host(means)[full]))))
        start = torch.as_tensor(host(st["centers"]), device=ref.x.device)
    return out
