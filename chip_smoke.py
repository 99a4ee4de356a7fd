#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FlashR on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printing one JSON line:

1. build   — compile every kernel of ``src/repro_torch/kernels/csrc`` with
             nvcc (all sources at once) and report the seconds.
2. kernel  — each of the four kernels at the main path's full shapes
             (X = 65,608,366 × 32 float32, the paper's Friendster-32 input,
             generated on the card from a seeded ``torch.Generator``), held
             against its plain PyTorch version on the same inputs — the
             float32 one, and for the sums of gram, wgram and kmeans_assign
             a float64 one, entry by entry — and timed with CUDA events
             beside its plain version, its roofline bound and, where one
             PyTorch call computes the same function, that call.  Each
             kernel's line is printed before its checks are applied.
3. small   — summary and correlation on a 4096-row slice against numpy.
4. main    — ``summary``, ``correlation``, ``glm(family="logistic",
             max_iter=8)`` and ``kmeans(k=10, max_iter=5)`` through
             ``repro_torch.core.fm`` with backend ``cuda`` (once to warm,
             then with the kernel launch counters set to 0 just before and
             read just after: every kernel must have launched, and every
             materialize must be one pass), then the same with backend
             ``torch``, and the two compared.  Wall times are the warm runs.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and last the line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line.  TF32 is switched off for matmul and cuDNN, so every plain
version and library call computes in full float32.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

N_ROWS = 65_608_366      # Friendster-32: rows of the paper's dense input
N_COLS = 32
K_CLUSTERS = 10
SEED = 2016
HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
CHUNK_ROWS = 1 << 22     # rows per chunk of a float64 plain version
#: Limits on a float32 kernel's error against its float64 plain version,
#: per entry, in units of that entry's condition: sqrt(G_ii·G_jj) for a Gram
#: entry (the units of a correlation), the sum of |terms| for a cluster sum,
#: the value itself for wss (a sum of positive terms).  A Gram diagonal adds
#: n positive terms and rounds in proportion to its size; an off-diagonal
#: entry of independent columns adds terms of both signs and rounds far
#: less, so it gets its own, tighter limit.  Both are set from the kernels'
#: measured error on this input (PERF.md): Gram diagonals 3.1e-6 and
#: 3.8e-6, off-diagonals 1.5e-9 and 1.7e-9, cluster sums 1.1e-6.
F64_TOL = 1e-5
F64_TOL_OFFDIAG = 2e-8

REPO = pathlib.Path(__file__).resolve().parent


def emit(obj):
    print(json.dumps(obj), flush=True)


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def row_chunks(n):
    return ((s, min(n, s + CHUNK_ROWS)) for s in range(0, n, CHUNK_ROWS))


def gram64(torch, x, w=None):
    """XᵀX, or XᵀWX with per-row weights w, in float64, a chunk of rows at
    a time."""
    p = x.shape[1]
    g = torch.zeros((p, p), dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc = x[s:e].double()
        g += (xc if w is None else xc * w[s:e].double()[:, None]).T @ xc
    return g


def corr_err(torch, g, g64):
    """|G − G64|_ij / sqrt(G64_ii · G64_jj), the error in the units of a
    correlation: its max over the diagonal and over the other entries."""
    d = g64.diagonal().clamp_min(1e-300).sqrt()
    e = (g.double() - g64).abs() / torch.outer(d, d)
    off = ~torch.eye(e.shape[0], dtype=torch.bool, device=e.device)
    return float(e.diagonal().max()), float(e[off].max()) if off.any() else 0.0


def lloyd64(torch, x, c, lab):
    """Cluster sums, their condition (sums of |x|), counts and wss of a
    Lloyd step with the given labels, in float64."""
    k, p = c.shape
    c64 = c.double()
    sums = torch.zeros((k, p), dtype=torch.float64, device=x.device)
    abs_sums = torch.zeros_like(sums)
    wss = torch.zeros((), dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc = x[s:e].double()
        lc = lab[s:e].long()
        onehot = torch.nn.functional.one_hot(lc, k).double()
        sums += onehot.T @ xc
        abs_sums += onehot.T @ xc.abs()
        wss += ((xc - c64[lc]) ** 2).sum()
    counts = torch.bincount(lab.long(), minlength=k).double()
    return sums, abs_sums, counts, wss


def make_data(torch):
    """X ~ N(0, 1); y from a logistic model with a fixed β; Xk: 10 blobs."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((N_ROWS, N_COLS), generator=gen, device=dev)
    beta = torch.as_tensor(
        np.random.default_rng(SEED).uniform(-0.5, 0.5, N_COLS),
        dtype=torch.float32, device=dev)
    prob = torch.sigmoid(x @ beta)
    y = (torch.rand(N_ROWS, generator=gen, device=dev) < prob).float()
    del prob
    centers = torch.randn((K_CLUSTERS, N_COLS), generator=gen,
                          device=dev) * 4.0
    lab = torch.randint(0, K_CLUSTERS, (N_ROWS,), generator=gen, device=dev)
    xk = torch.randn((N_ROWS, N_COLS), generator=gen, device=dev)
    xk += centers[lab]
    del lab
    torch.cuda.synchronize()
    return x, y, xk


def kernel_phase(torch, x, xk):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import fm
    from repro_torch.algorithms.kmeans import _init_centers
    from repro_torch.core.fusion import Plan
    from repro_torch.kernels import (fused_apply_agg as faa, gram as gram_mod,
                                     kmeans_assign as ka, ref,
                                     weighted_gram as wg)
    n, p = x.shape
    rows = []

    # gram: correlation's crossprod(X).
    g = gram_mod.gram(x)
    err = rel_err(torch, g, ref.gram_ref(x))
    g64 = gram64(torch, x)
    diag64, off64 = corr_err(torch, g, g64)
    plain64 = corr_err(torch, ref.gram_ref(x), g64)
    b = bound(n * p * 4 + p * p * 4, 2 * n * p * p)
    row = dict(
        name="gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:54",
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, diag_err_f64=diag64, tol_f64=F64_TOL,
        offdiag_err_f64=off64, tol_offdiag_f64=F64_TOL_OFFDIAG,
        plain_f32_diag_offdiag_err_f64=plain64,
        ms=time_ms(torch, lambda: gram_mod.gram(x)),
        plain_ms=time_ms(torch, lambda: ref.gram_ref(x)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.matmul(x.T, x)))
    emit({"phase": "kernel", **row})
    check(err <= 1e-4, f"gram rel err {err} against the f32 plain version")
    check(diag64 <= F64_TOL and off64 <= F64_TOL_OFFDIAG,
          f"gram err {diag64} on the diagonal, {off64} off it (correlation "
          "units) against the f64 plain version")
    rows.append(row)
    del g, g64

    # wgram: the IRLS weights of the first Newton step (beta = 0) are 0.25;
    # use weights that vary per row so the reweighting is exercised.
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SEED + 1)
    w = torch.rand(n, generator=gen, device=x.device) * 0.25 + 1e-6
    g = wg.wgram(x, w)
    err = rel_err(torch, g, ref.wgram_ref(x, w))
    g64 = gram64(torch, x, w)
    diag64, off64 = corr_err(torch, g, g64)
    plain64 = corr_err(torch, ref.wgram_ref(x, w), g64)
    b = bound(n * p * 4 + n * 4 + p * p * 4, 2 * n * p * p + n * p)
    row = dict(
        name="wgram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/weighted_gram.py:63",
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, diag_err_f64=diag64, tol_f64=F64_TOL,
        offdiag_err_f64=off64, tol_offdiag_f64=F64_TOL_OFFDIAG,
        plain_f32_diag_offdiag_err_f64=plain64,
        ms=time_ms(torch, lambda: wg.wgram(x, w)),
        plain_ms=time_ms(torch, lambda: ref.wgram_ref(x, w), reps=2),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.einsum("ni,n,nj->ij", x, w, x),
                           reps=2))
    emit({"phase": "kernel", **row})
    check(err <= 1e-4, f"wgram rel err {err} against the f32 plain version")
    check(diag64 <= F64_TOL and off64 <= F64_TOL_OFFDIAG,
          f"wgram err {diag64} on the diagonal, {off64} off it (correlation "
          "units) against the f64 plain version")
    rows.append(row)
    del g, g64, w

    # fused_apply_agg: the chains the engine builds for summary().
    X = fm.conv_R2FM(x)
    outs = (fm.colMins(X), fm.colMaxs(X), fm.colSums(X),
            fm.colSums(fm.abs_(X)), fm.colSums(X ** 2),
            fm.agg_col(X, "count_nonzero"))
    units = Plan([o.m for o in outs]).program("cuda").kernel_units
    check([u.kernel for u in units] == ["fused_apply_agg"],
          f"summary plan lowers to {[u.kernel for u in units]}")
    chains = units[0].chains
    got = faa.fused_apply_agg(x, chains)
    want = ref.fused_apply_agg_ref(x, chains)
    err = 0.0
    max_abs = 0.0
    failed = []
    for (unaries, agg, acc), a, r in zip(chains, got, want):
        max_abs = max(max_abs, float((a.double() - r.double()).abs().max()))
        if agg in ("min", "max", "count", "count_nonzero"):
            if not torch.equal(a, r):
                failed.append(f"fused_apply_agg {agg} not exact")
        else:
            e = rel_err(torch, a, r)
            if e > 1e-4:
                failed.append(f"fused_apply_agg {unaries} {agg} rel err {e}")
            err = max(err, e)
    n_ops = sum(len(u) + 1 for u, _, _ in chains)
    b = bound(n * p * 4 + len(chains) * p * 4, n * p * n_ops)
    row = dict(
        name="fused_apply_agg", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_apply_agg.cu",
        replaces="src/repro/kernels/fused_apply_agg.py:177",
        max_abs_err=max_abs, rel_err=err, tol=1e-4,
        ms=time_ms(torch, lambda: faa.fused_apply_agg(x, chains)),
        plain_ms=time_ms(torch, lambda: ref.fused_apply_agg_ref(x, chains),
                         reps=2),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    emit({"phase": "kernel", **row})
    check(not failed, "; ".join(failed))
    rows.append(row)
    del got, want

    # kmeans_assign: the first Lloyd step of kmeans(k=10) on the blobs.
    c = torch.as_tensor(_init_centers(fm.conv_R2FM(xk), K_CLUSTERS, 0),
                        device=x.device)
    lab, sums, cnts, wss = ka.kmeans_assign(xk, c)
    rlab, rsums, rcnts, rwss = ref.kmeans_assign_ref(xk, c)
    failed = []
    bad = (lab != rlab).nonzero().reshape(-1)
    if bad.numel():
        xb = xk[bad].double()
        cd = c.double()
        da = ((xb - cd[lab[bad].long()]) ** 2).sum(1)
        dr = ((xb - cd[rlab[bad].long()]) ** 2).sum(1)
        tie = (da - dr).abs() <= 1e-5 * torch.maximum(da, dr).clamp_min(1.0)
        if not bool(tie.all()):
            failed.append(f"kmeans labels differ off near-ties "
                          f"({int((~tie).sum())} rows)")
    mism = int(bad.numel())
    if float((cnts - rcnts).abs().sum()) > 2 * mism:
        failed.append("kmeans counts against the f32 plain version")
    e_s = rel_err(torch, sums, rsums)
    e_w = rel_err(torch, wss, rwss)
    if not (e_s <= 1e-4 and e_w <= 1e-4):
        failed.append(f"kmeans sums {e_s} wss {e_w} against the f32 plain "
                      "version")
    # float64, given the kernel's labels: each cluster sum against the sum
    # of |x| it adds up, wss against itself, counts against a bincount.
    s64, a64, c64, w64 = lloyd64(torch, xk, c, lab)
    e_s64 = float(((sums.double() - s64).abs() / a64.clamp_min(1e-300)).max())
    e_w64 = float((wss.double() - w64).abs().max() / w64)
    e_c64 = float(((cnts.double() - c64).abs() / c64.clamp_min(1.0)).max())
    if max(e_s64, e_w64, e_c64) > F64_TOL:
        failed.append(f"kmeans sums {e_s64} wss {e_w64} counts {e_c64} "
                      "against the f64 plain version")
    k = K_CLUSTERS
    b = bound(n * p * 4 + n * 4 + k * p * 4 + (k * p + k + 1) * 4,
              n * (2 * p + 2 * k * p + 3 * k + p))
    row = dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:96",
        max_abs_err=max(float((sums.double() - s64).abs().max()),
                        float((wss.double() - w64).abs().max())),
        rel_err=max(e_s, e_w), tol=1e-4, label_mismatches_at_ties=mism,
        sums_err_f64=e_s64, wss_err_f64=e_w64, counts_err_f64=e_c64,
        tol_f64=F64_TOL, wss=[float(wss), float(rwss), float(w64)],
        ms=time_ms(torch, lambda: ka.kmeans_assign(xk, c)),
        plain_ms=time_ms(torch, lambda: ref.kmeans_assign_ref(xk, c), reps=2),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    emit({"phase": "kernel", **row})
    check(not failed, "; ".join(failed))
    rows.append(row)
    del lab, sums, cnts, wss, rlab, rsums, rcnts, rwss
    torch.cuda.empty_cache()
    return rows


def small_phase(x):
    """summary and correlation on 4096 rows against numpy."""
    import numpy as np
    from repro_torch.algorithms import correlation, summary
    from repro_torch.core import fm
    xs = x[:4096].cpu().numpy()
    X = fm.conv_R2FM(xs)
    s = summary(X)
    np.testing.assert_allclose(s.mean, xs.mean(0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, xs.var(0, ddof=1), rtol=1e-2)
    np.testing.assert_allclose(s.col_min, xs.min(0))
    np.testing.assert_allclose(s.col_max, xs.max(0))
    np.testing.assert_allclose(s.l1, np.abs(xs).sum(0), rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, (xs != 0).sum(0))
    c = correlation(X)
    np.testing.assert_allclose(c, np.corrcoef(xs.T), rtol=2e-2, atol=2e-3)
    emit({"phase": "small", "rows": xs.shape[0], "ok": True})


def run_algorithms(torch, x, y, xk):
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    X, Y, XK = fm.conv_R2FM(x), fm.conv_R2FM(y), fm.conv_R2FM(xk)
    out, wall = {}, {}
    for name, fn in (("summary", lambda: summary(X)),
                     ("correlation", lambda: correlation(X)),
                     ("glm", lambda: glm(X, Y, family="logistic", max_iter=8)),
                     ("kmeans", lambda: kmeans(XK, k=K_CLUSTERS, max_iter=5))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
    return out, wall


def main_phase(torch, x, y, xk):
    import numpy as np
    from repro_torch.core import fm
    from repro_torch.kernels import (fused_apply_agg as faa, gram as gram_mod,
                                     kmeans_assign as ka, weighted_gram as wg)
    mods = {"gram": gram_mod, "wgram": wg, "fused_apply_agg": faa,
            "kmeans_assign": ka}
    with fm.conf(backend="cuda"):
        run_algorithms(torch, x, y, xk)  # warm: plan cache, libraries
        fm.reset_exec_stats()
        for m in mods.values():
            m.launches = 0
        res, wall = run_algorithms(torch, x, y, xk)
    launches = {k: m.launches for k, m in mods.items()}
    st = fm.exec_stats()
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(st["passes"] == st["materialize_calls"],
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']}")
    emit({"phase": "main", "backend": "cuda", "wall_s": wall,
          "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"],
          "glm_iters": res["glm"].iters, "kmeans_iters": res["kmeans"].iters})

    with fm.conf(backend="torch"):
        run_algorithms(torch, x, y, xk)
        ref_res, ref_wall = run_algorithms(torch, x, y, xk)
    emit({"phase": "main", "backend": "torch", "wall_s": ref_wall,
          "glm_iters": ref_res["glm"].iters,
          "kmeans_iters": ref_res["kmeans"].iters})

    s, r = res["summary"], ref_res["summary"]
    np.testing.assert_allclose(s.mean, r.mean, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, r.var, rtol=1e-2)
    np.testing.assert_allclose(s.col_min, r.col_min)
    np.testing.assert_allclose(s.col_max, r.col_max)
    np.testing.assert_allclose(s.l1, r.l1, rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, r.nnz)
    np.testing.assert_allclose(res["correlation"], ref_res["correlation"],
                               rtol=2e-2, atol=2e-3)
    g, gr = res["glm"], ref_res["glm"]
    check(np.isfinite(g.beta).all() and g.beta.shape == (N_COLS,), "glm beta")
    np.testing.assert_allclose(g.beta, gr.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(g.loglik, gr.loglik, rtol=1e-5)
    km, kr = res["kmeans"], ref_res["kmeans"]
    check(np.isfinite(km.centers).all()
          and km.centers.shape == (K_CLUSTERS, N_COLS), "kmeans centers")
    np.testing.assert_allclose(km.wss, kr.wss, rtol=1e-3)
    emit({"phase": "compare", "ok": True,
          "glm_loglik": [g.loglik, gr.loglik],
          "kmeans_wss": [km.wss, kr.wss]})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    src = REPO / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import fm
    from repro_torch.kernels import build
    fm.set_conf(device="cuda")
    t0 = time.perf_counter()
    build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(build.SOURCES), "tf32": False})

    x, y, xk = make_data(torch)
    emit({"phase": "data", "shape": [N_ROWS, N_COLS], "dtype": "float32",
          "gib": x.numel() * 4 / 2**30, "seed": SEED})
    rows = kernel_phase(torch, x, xk)
    small_phase(x)
    launches = main_phase(torch, x, y, xk)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (CheckFailed, AssertionError) as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
