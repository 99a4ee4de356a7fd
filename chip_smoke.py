#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FlashR on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printing one JSON line:

1. build   — compile every kernel of ``src/repro_torch/kernels/csrc`` with
             nvcc (all sources at once) and report the seconds.
2. kernel  — each dense kernel at the main paths' full shapes (X =
             65,608,366 × 32 float32, the paper's Friendster-32 input,
             generated on the card from a seeded ``torch.Generator``; xty at
             NMF's and GMM's shapes, its rows naming the thin body's width,
             splits, registers and spills; wgram's row naming the body
             that ran, its chunk rows, stages, splits and shared bytes,
             registers and spills), held against its plain PyTorch version
             on the same inputs — the float32 one, and for the sums a
             float64 one, entry by entry — and timed with CUDA events beside
             its plain version, its roofline bound and, where one PyTorch
             call computes the same function, that call.  Each kernel's line
             is printed before its checks are applied.
3. small   — summary, correlation, SVD, PCA and naive Bayes on a 4096-row
             slice against numpy.
4. main    — three paths through ``repro_torch.core.fm``, each with the
             kernel launch counters set to 0 just before it and read just
             after (every kernel of the path must have launched):
             a. ``summary``, ``correlation``, ``glm(family="logistic",
                max_iter=8)`` and ``kmeans(k=10, max_iter=5)`` with backend
                ``cuda`` (once to warm, then counted; every materialize is
                one pass), then with backend ``torch``, compared;
             b. ``svd_tall(k=10, compute_u=True)``, ``pca(k=10)``,
                ``nmf(|X|, k=8, max_iter=3)``, ``gmm(k=10, max_iter=3)`` on
                the 10 blobs and ``naive_bayes`` + ``nb_predict`` on the
                blobs' labels, on ``cuda`` (every materialize one pass but
                pca's two; GMM's peak memory printed), then on ``torch``,
                compared;
             c. after the dense data is freed, the sparse path at the scale
                of the Criteo Display Advertising Challenge train set
                (Kaggle, 2014): 45,840,617 rows × 26 categorical columns,
                each hashed to 64 buckets (ncol = 1,664, a cut: the kernels
                hold a dense ncol × ncol Gram), codes drawn per column from
                a Zipf-like law and y from a logistic model; first the SpMM
                kernel rows (as phase 2), then ``glm(Xs, y, "logistic",
                ridge=1e-3, max_iter=8)`` and one ``crossprod(Xs)`` on
                ``cuda``, checked for convergence and exact level counts
                (the ``spmm_gram`` / ``spmm_wgram`` rows also print the
                kernel's design — threads, tile edge, tiles, splits, body,
                registers and spills — and ``pair_products``, the in-tile
                shared-memory atomics of one call, counted on the card from
                each row's per-stripe entry counts; the ``spmm_xty`` row its
                design — warps, stripe, tiles, splits, rows in flight,
                swizzle, registers and spills — and ``deterministic``, two
                calls equal bit for bit, checked);
                ``torch``, which densifies, is compared with ``cuda`` on the
                first 2^18 rows;
             d. after the Criteo data is freed, the LM serving path
                (``repro_torch.launch.steps``) at llama3.2-3b's published
                width — 28 layers, d_model 3072, 24 heads over 8 KV heads,
                head dim 128, d_ff 8192, vocab 128,256 — with bf16 parameters
                drawn from seed 2016: first the ``flash_attention`` kernel
                row (B 4, 24 q heads, 8 KV heads, S = T = 4096, bf16, causal,
                held within one bf16 rounding of its f32 plain version and of
                float64 on a few heads, and an f32 case; the row names the
                kernel body that ran, its design bound and its registers and
                spills from the build log, and a head-dim-112 case — zamba2-
                7b's 32 heads, S = 4096, bf16, causal, on the FMA body —
                held to the same rule, its time printed), then 4 prompts of
                4096 random tokens prefilled (the kernel must launch once per
                layer) and 32 greedy decode steps, counted; then the checks,
                at the same shape with the same weights and activations
                widened to float32 (in bf16 both read the rounding noise of
                these random weights, PERF.md; those readings are printed):
                (a) the last-position logits against the same prefill with
                the plain attention (``attn_impl="ref"``); (b) prefill + one
                decode step against a prefill one token longer (the twin of
                tests/test_archs.py); (c) is (a) in float32, which (a) now
                is at the full shape; (d) every logit finite.

Then one ``{"kernels": [...]}`` line (launches summed over the four
paths), the card's name and power limit as ``nvidia-smi`` prints them, and
last the line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the last line.  TF32 is switched off for matmul and cuDNN,
so every plain version and library call computes in full float32.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

N_ROWS = 65_608_366      # Friendster-32: rows of the paper's dense input
N_COLS = 32
K_CLUSTERS = 10
NMF_K = 8
SEED = 2016
CRITEO_ROWS = 45_840_617  # Criteo Display Advertising Challenge train set
CRITEO_FACTORS = 26       # its categorical columns
CRITEO_BUCKETS = 64       # hash buckets a column (a cut, see the docstring)
ZIPF_S = 1.1              # P(bucket k) ∝ (k + 1)^-s
SPARSE_CMP_ROWS = 1 << 18  # rows on which the densifying torch backend runs
DEVICE = "cuda"
HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
BF16_FLOP_S = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
LM_ARCH = "llama3.2-3b"  # the serving path's model, at its published width
LM_BATCH = 4             # prompts a prefill
LM_PROMPT = 4096         # tokens a prompt
LM_DECODE = 32           # greedy decode steps
#: Limit of the serving checks (a) and (b), in float32: max |diff| over
#: max |logit|.  The JAX package's bf16 limit (tests/test_archs.py) is 2e-2.
LM_F32_TOL = 1e-3
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

#: Each kernel's launch counter: (module of repro_torch.kernels, attribute).
COUNTERS = {
    "gram": ("gram", "launches"),
    "xty": ("gram", "xty_launches"),
    "fused_apply_agg": ("fused_apply_agg", "launches"),
    "wgram": ("weighted_gram", "launches"),
    "kmeans_assign": ("kmeans_assign", "launches"),
    "spmm_gram": ("spmm", "gram_launches"),
    "spmm_xty": ("spmm", "xty_launches"),
    "spmm_wgram": ("spmm", "wgram_launches"),
    "flash_attention": ("flash_attention", "launches"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"repro_torch.kernels.{mod}"), attr


def zero_counts():
    for name in COUNTERS:
        mod, attr = _counter(name)
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(*_counter(name)) for name in COUNTERS}


def counted(torch, path, kernels, run):
    """Drive one main path with every launch counter set to 0 just before
    and read just after; each of ``kernels`` must have launched."""
    torch.cuda.synchronize()
    zero_counts()
    out = run()
    torch.cuda.synchronize()
    got = read_counts()
    check(all(got[k] > 0 for k in kernels),
          f"a kernel of the {path} path never launched: "
          f"{ {k: got[k] for k in kernels} }")
    return out, got


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


def bound(nbytes, ops, flop_s=F32_FLOP_S):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / flop_s * 1e3
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
    """X ~ N(0, 1); y from a logistic model with a fixed β; Xk: 10 blobs
    and their labels."""
    import numpy as np
    dev = torch.device(DEVICE)
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
    torch.cuda.synchronize()
    return x, y, xk, lab.to(torch.int32)


def kernel_phase(torch, x, xk):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import fm
    from repro_torch.algorithms.kmeans import _init_centers
    from repro_torch.core.fusion import Plan
    from repro_torch.kernels import (build, fused_apply_agg as faa,
                                     gram as gram_mod, kmeans_assign as ka,
                                     ref, weighted_gram as wg)
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
    tri_before = wg.tri_launches
    g = wg.wgram(x, w)
    plan = gram_mod.wgram_plan(n, p, x.dtype)
    body = "tri" if wg.tri_launches > tri_before else "tile"
    err = rel_err(torch, g, ref.wgram_ref(x, w))
    g64 = gram64(torch, x, w)
    diag64, off64 = corr_err(torch, g, g64)
    plain64 = corr_err(torch, ref.wgram_ref(x, w), g64)
    b = bound(n * p * 4 + n * 4 + p * p * 4, 2 * n * p * p + n * p)
    row = dict(
        name="wgram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/weighted_gram.py:63", body=body,
        design=dict(chunk_rows=plan.chunk_rows, stages=plan.stages,
                    splits=plan.splits, rows_per_split=plan.rows_per_split,
                    smem_bytes=plan.smem_bytes,
                    threads=gram_mod.TRI_THREADS,
                    blocks_per_sm=gram_mod.TRI_BLOCKS_PER_SM),
        ptxas=build.ptxas_report("gram", "wgram_tri_partials"),
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
    check(body == plan.body, f"wgram ran the {body} body, its plan says "
          f"{plan.body}")
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

    # xty at NMF's pass-A shape, WᵀX with W (n, 8) ≥ 0 and |X|, and at
    # GMM's, Xᵀr with r (n, 1) the responsibilities of one component.
    gen.manual_seed(SEED + 2)
    w_nmf = torch.rand((n, NMF_K), generator=gen, device=x.device)
    xa = x.abs()
    row = xty_row(torch, w_nmf, xa, "nmf")
    del w_nmf, xa
    r = torch.rand((n, 1), generator=gen, device=x.device)
    row["at_gmm_shape"] = xty_row(torch, xk, r, "gmm")
    rows.append(row)
    del r
    torch.cuda.empty_cache()
    return rows


def xty64(torch, x, y):
    """XᵀY in float64, a chunk of rows at a time, and the units of its
    entries: sqrt(Σx_i² · Σy_j²)."""
    g = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float64,
                    device=x.device)
    nx = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    ny = torch.zeros(y.shape[1], dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc, yc = x[s:e].double(), y[s:e].double()
        g += xc.T @ yc
        nx += (xc * xc).sum(0)
        ny += (yc * yc).sum(0)
    return g, torch.outer(nx.sqrt(), ny.sqrt()).clamp_min(1e-300)


def xty_row(torch, x, y, shape):
    """The xty kernel on (x, y) against its plain versions; returns its
    row after printing it."""
    from repro_torch.kernels import build, gram as gram_mod, ref
    n, p = x.shape
    q = y.shape[1]
    g = gram_mod.xty(x, y)
    plain = ref.xty_ref(x, y)
    err = rel_err(torch, g, plain)
    g64, units = xty64(torch, x, y)
    e64 = float(((g.double() - g64).abs() / units).max())
    plain64 = float(((plain.double() - g64).abs() / units).max())
    b = bound(n * (p + q) * 4 + p * q * 4, 2 * n * p * q)
    na = gram_mod.thin_width(min(p, q))
    row = dict(
        name="xty", shape=f"{shape}: ({n}, {p})ᵀ·({n}, {q})", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:92",
        body=f"thin, narrow width {na}, 16-byte loads",
        splits=gram_mod.xty_plan(n, p, q)[0],
        ptxas=build.ptxas_report("gram", f"xty_thin_partialsIfLi{na}ELb1E"),
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, err_f64=e64, tol_f64=F64_TOL,
        plain_f32_err_f64=plain64,
        ms=time_ms(torch, lambda: gram_mod.xty(x, y)),
        plain_ms=time_ms(torch, lambda: ref.xty_ref(x, y)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.matmul(x.T, y)))
    emit({"phase": "kernel", **row})
    check(err <= 1e-4, f"xty ({shape}) rel err {err} against the f32 plain "
          "version")
    check(e64 <= F64_TOL, f"xty ({shape}) err {e64} against the f64 plain "
          "version")
    return row


def small_phase(x, xk, lab):
    """summary, correlation, SVD, PCA and naive Bayes on 4096 rows against
    numpy."""
    import numpy as np
    from repro_torch.algorithms import (correlation, naive_bayes, pca,
                                        summary, svd_tall)
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
    r = svd_tall(X, k=6)
    np.testing.assert_allclose(
        r.s, np.linalg.svd(xs.astype(np.float64), compute_uv=False)[:6],
        rtol=1e-3)
    xc = xs.astype(np.float64) - xs.mean(0)
    np.testing.assert_allclose(
        pca(X, k=4).sdev, np.linalg.svd(xc, compute_uv=False)[:4]
        / np.sqrt(xs.shape[0] - 1), rtol=1e-3)
    xks, ls = xk[:4096].cpu().numpy(), lab[:4096].cpu().numpy()
    m = naive_bayes(fm.conv_R2FM(xks), fm.conv_R2FM(ls), K_CLUSTERS)
    for j in range(K_CLUSTERS):
        np.testing.assert_allclose(m.means[j], xks[ls == j].mean(0),
                                   rtol=1e-4, atol=1e-4)
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
    with fm.conf(backend="cuda"):
        run_algorithms(torch, x, y, xk)  # warm: plan cache, libraries
        fm.reset_exec_stats()
        (res, wall), launches = counted(
            torch, "dense main", ("gram", "wgram", "fused_apply_agg",
                                  "kmeans_assign"),
            lambda: run_algorithms(torch, x, y, xk))
    st = fm.exec_stats()
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


def run_a8(torch, x, xk, lab):
    """The rest of the dense algorithms, each timed by the host clock around
    a call that ends in a synchronize; GMM's peak device memory with it."""
    from repro_torch.algorithms import (gmm, naive_bayes, nb_predict, nmf,
                                        pca, svd_tall)
    from repro_torch.core import fm, materialize
    X, XK, L = fm.conv_R2FM(x), fm.conv_R2FM(xk), fm.conv_R2FM(lab)
    out, wall = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0

    timed("svd_tall", lambda: svd_tall(X, k=10, compute_u=True))
    # keep what the comparison reads; drop the full-height results
    out["svd_tall"].U = fm._fm(out["svd_tall"].U).logical_data()[:4096].cpu()
    timed("pca", lambda: pca(X, k=10))
    XA = fm.conv_R2FM(x.abs())
    timed("nmf", lambda: nmf(XA, k=NMF_K, max_iter=3))
    out["nmf"].W = None
    del XA
    # cached plans hold their source matrices: drop them with |X|
    materialize.clear_plan_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed("gmm", lambda: gmm(XK, k=K_CLUSTERS, max_iter=3))
    peak = torch.cuda.max_memory_allocated()
    timed("naive_bayes", lambda: naive_bayes(XK, L, K_CLUSTERS))
    timed("nb_predict", lambda: nb_predict(out["naive_bayes"], XK))
    return out, wall, peak


def algorithms_phase(torch, x, xk, lab):
    """Path b: svd_tall, pca, nmf, gmm and naive Bayes on cuda (counted),
    then on torch, compared."""
    import numpy as np
    from repro_torch.core import fm
    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (res, wall, peak), launches = counted(
            torch, "algorithms", ("gram", "xty", "wgram", "fused_apply_agg"),
            lambda: run_a8(torch, x, xk, lab))
    st = fm.exec_stats()
    # every materialize is one pass, but pca's two
    check(st["passes"] == st["materialize_calls"] + 1,
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']} + 1 (pca)")
    emit({"phase": "main", "path": "algorithms", "backend": "cuda",
          "wall_s": wall, "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"],
          "gmm_rows": N_ROWS, "gmm_max_memory_allocated": peak,
          "gmm_max_memory_gib": peak / 2**30,
          "nmf_iters": res["nmf"].iters, "gmm_iters": res["gmm"].iters})
    with fm.conf(backend="torch"):
        ref, ref_wall, ref_peak = run_a8(torch, x, xk, lab)
    emit({"phase": "main", "path": "algorithms", "backend": "torch",
          "wall_s": ref_wall, "gmm_max_memory_allocated": ref_peak})

    # X ~ N(0, 1): XᵀX ≈ n·I, so its eigenvalues are close together and the
    # eigenvectors move with float32 noise in the Gram; the singular values
    # do not.  Each backend's U is held to its own V: U = X V Σ⁻¹.
    s, r = res["svd_tall"], ref["svd_tall"]
    check(np.isfinite(s.s).all() and s.V.shape == (N_COLS, 10), "svd")
    np.testing.assert_allclose(s.s, r.s, rtol=1e-4)
    x0 = x[:4096].double().cpu().numpy()
    for v in (s, r):
        np.testing.assert_allclose(v.U.double().numpy(), x0 @ v.V / v.s,
                                   rtol=1e-3, atol=1e-7)
    a, b = res["pca"], ref["pca"]
    np.testing.assert_allclose(a.sdev, b.sdev, rtol=1e-4)
    np.testing.assert_allclose(a.center, b.center, rtol=1e-4, atol=1e-6)
    a, b = res["nmf"], ref["nmf"]
    check(np.isfinite(a.H).all() and a.H.shape == (NMF_K, N_COLS), "nmf H")
    np.testing.assert_allclose(a.objective_trace, b.objective_trace,
                               rtol=1e-3)
    np.testing.assert_allclose(a.H, b.H, rtol=1e-2, atol=1e-4)
    a, b = res["gmm"], ref["gmm"]
    check(np.isfinite(a.means).all() and a.covs.shape == (
        K_CLUSTERS, N_COLS, N_COLS), "gmm")
    t = np.array(a.loglik_trace)
    check((np.diff(t) > -1e-2 * np.abs(t[:-1])).all(), f"gmm loglik {t}")
    np.testing.assert_allclose(a.loglik_trace, b.loglik_trace, rtol=1e-4)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-4)
    a, b = res["naive_bayes"], ref["naive_bayes"]
    np.testing.assert_allclose(a.means, b.means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a.variances, b.variances, rtol=1e-3)
    pa, pb = (fm._fm(v).logical_data() for v in (res["nb_predict"],
                                                 ref["nb_predict"]))
    agree = float((pa == pb).float().mean())
    acc = float((pa.reshape(-1) == lab).float().mean())
    check(agree >= 0.9999, f"nb_predict agreement {agree}")
    check(acc > 0.9, f"nb_predict accuracy {acc} on the blobs")
    emit({"phase": "compare", "path": "algorithms", "ok": True,
          "svd_s0": [float(s.s[0]), float(r.s[0])],
          "gmm_loglik": [res["gmm"].loglik, ref["gmm"].loglik],
          "nmf_objective": [res["nmf"].objective, ref["nmf"].objective],
          "nb_predict_agreement": agree, "nb_accuracy": acc})
    return launches


def make_criteo(torch):
    """The Criteo-shaped slab on the card: per column, a bucket drawn from
    P(k) ∝ (k + 1)^-ZIPF_S over CRITEO_BUCKETS buckets, offset to the
    column's block; y ~ Bernoulli(sigmoid(Σ β[col])) with β from the seed."""
    import numpy as np
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n, f, b = CRITEO_ROWS, CRITEO_FACTORS, CRITEO_BUCKETS
    w = np.arange(1, b + 1, dtype=np.float64) ** -ZIPF_S
    cdf = torch.as_tensor(np.cumsum(w) / w.sum(), device=dev)
    beta = torch.as_tensor(np.random.default_rng(SEED).normal(0.0, 0.3, f * b),
                           dtype=torch.float32, device=dev)
    cols = torch.empty((n, f), dtype=torch.int32, device=dev)
    eta = torch.zeros(n, device=dev)
    for j in range(f):
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        c = torch.searchsorted(cdf, u).clamp_max_(b - 1) + j * b
        cols[:, j] = c
        eta += beta[c]
        del u, c
    vals = torch.ones((n, f), device=dev)
    eta -= eta.mean()
    y = (torch.rand(n, generator=gen, device=dev)
         < torch.sigmoid(eta)).float().reshape(-1, 1)
    del eta
    torch.cuda.synchronize()
    return cols, vals, y


def sparse_fm(cols, vals):
    """The slab as an fm matrix: the device-tier store fm.one_hot builds."""
    import torch
    from repro_torch.core import fm
    from repro_torch.core.matrix import FMMatrix
    from repro_torch.storage import SparseEllStore
    n, f = cols.shape
    store = SparseEllStore(cols, vals, f * CRITEO_BUCKETS, nnz=n * f)
    return fm.FM(FMMatrix(store.shape, torch.float32, store=store))


def tile_pairs(torch, cols, vals, ts):
    """The shared-memory atomics one spmm_gram / spmm_wgram call makes: per
    row, h_I stored non-zero entries in stripe I of ts columns, and tile
    (I, J), I <= J, takes h_I·h_J of its pairs, so a row adds
    ((Σ h_I)² + Σ h_I²) / 2; counted on the card a chunk of rows at a
    time."""
    ncol = CRITEO_FACTORS * CRITEO_BUCKETS
    nst = -(-ncol // ts)
    total = 0
    for a, b in row_chunks(cols.shape[0]):
        c = cols[a:b].long()
        ok = ((vals[a:b] != 0) & (c >= 0) & (c < ncol)).double()
        h = torch.zeros((b - a, nst + 1), dtype=torch.float64,
                        device=cols.device)
        h.scatter_add_(1, torch.where(ok > 0, c // ts, nst), ok)
        h = h[:, :nst]
        total += int(((h.sum(1) ** 2 + (h * h).sum(1)) / 2).sum())
    return total


def spmm_rows(torch, cols, vals):
    """The three SpMM kernels at the Criteo shape against their plain
    versions (float32 and float64, both a chunk of rows at a time)."""
    from repro_torch.kernels import build, ref, spmm
    n, kmax = cols.shape
    ncol = CRITEO_FACTORS * CRITEO_BUCKETS
    gen = torch.Generator(device=cols.device)
    gen.manual_seed(SEED + 3)
    w = torch.rand(n, generator=gen, device=cols.device) * 0.25 + 1e-6
    z = torch.randn((n, 1), generator=gen, device=cols.device)
    slab = n * kmax * 8
    rows = []
    ts, tiles, splits = spmm.gram_layout(n, ncol)
    design = dict(threads=spmm.GRAM_THREADS, ts=ts, tiles=tiles,
                  splits=splits, rows_in_flight_per_warp=3,
                  body="warp per row; a warp step per in-tile entry of the "
                       "row's I side, the J side's lanes adding (kept over "
                       "numbering the pairs on the lanes, PERF.md)",
                  pair_products=tile_pairs(torch, cols, vals, ts),
                  ptxas=build.ptxas_report("spmm", "spmm_gram_partials"))

    def finish(row, err, e64s, extra_checks=()):
        emit({"phase": "kernel", **row})
        check(err <= 1e-4, f"{row['name']} rel err {err} against the f32 "
              "plain version")
        for what, e in e64s:
            check(e <= F64_TOL, f"{row['name']} {what} err {e} against the "
                  "f64 plain version")
        for ok, what in extra_checks:
            check(ok, f"{row['name']}: {what}")
        rows.append(row)

    # spmm_gram: crossprod(Xs).  For a one-hot slab the diagonal is the
    # level counts, integers a float32 sum holds exactly (< 2^24).
    g = spmm.spmm_gram(cols, vals, ncol=ncol)
    gp = ref.spmm_gram_ref(cols, vals, ncol)
    g64 = ref.spmm_gram_ref(cols, vals, ncol, torch.float64)
    counts = torch.bincount(cols.reshape(-1).long(), minlength=ncol).double()
    d64, o64 = corr_err(torch, g, g64)
    b = bound(slab + ncol * ncol * 4, 2 * n * kmax * kmax)
    row = dict(
        name="spmm_gram", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:77", design=design,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, diag_err_f64=d64,
        offdiag_err_f64=o64, tol_f64=F64_TOL,
        plain_f32_diag_offdiag_err_f64=corr_err(torch, gp, g64),
        diag_equals_level_counts=bool(torch.equal(g.diagonal().double(),
                                                  counts)),
        ms=time_ms(torch, lambda: spmm.spmm_gram(cols, vals, ncol=ncol),
                   reps=3),
        plain_ms=time_ms(torch, lambda: ref.spmm_gram_ref(cols, vals, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call: torch.sparse.mm(Xᵀ, X) "
                     "returns a sparse product whose intermediate pair "
                     "products (3.1e10) exceed the card")
    finish(row, row["rel_err"], (("diagonal", d64), ("off-diagonal", o64)),
           ((row["diag_equals_level_counts"], "diagonal is not the level "
             "counts"),))
    units = g64.diagonal().clamp_min(1e-300).sqrt()
    del g, gp, g64

    # spmm_xty: the sparse IRLS XᵀWz (q = 1), against a float64 version in
    # the units sqrt(Σ_r X_rc² · Σ_r z_r²).
    zn = float(z.double().pow(2).sum().sqrt())
    g = spmm.spmm_xty(cols, vals, z, ncol=ncol)
    deterministic = bool(torch.equal(g, spmm.spmm_xty(cols, vals, z,
                                                      ncol=ncol)))
    cs, qc, warps, xtiles, xsplits = spmm.xty_layout(n, ncol, z.shape[1])
    xdesign = dict(warps=warps, stripe_rows=cs, stripe_cols=qc,
                   tiles=xtiles, splits=xsplits,
                   rows_in_flight_per_warp=spmm.XTY_AHEAD,
                   smem_bytes=4 * warps * spmm.xty_copy_floats(cs * qc),
                   swizzle="e + (e >> 6)",
                   body="warp per row, a private stripe a warp, no atomics",
                   ptxas=build.ptxas_report("spmm", "spmm_xty_partials"))
    gp = ref.spmm_xty_ref(cols, vals, z, ncol)
    g64 = ref.spmm_xty_ref(cols, vals, z, ncol, torch.float64)
    e64 = float(((g.double() - g64).abs().reshape(-1) / (units * zn)).max())
    b = bound(slab + n * 4 + ncol * 4, 2 * n * kmax)
    library_ms, note = None, None
    try:
        crow = torch.arange(0, n + 1, dtype=torch.int32,
                            device=cols.device) * kmax
        x_csr = torch.sparse_csr_tensor(crow, cols.reshape(-1),
                                        vals.reshape(-1), size=(n, ncol),
                                        check_invariants=False)
        lib = torch.sparse.mm(x_csr.t(), z)
        note = (f"torch.sparse.mm(Xᵀ, z) over a CSR view of the slab, "
                f"rel err {rel_err(torch, lib, g64)}")
        library_ms = time_ms(torch, lambda: torch.sparse.mm(x_csr.t(), z),
                             reps=1)
        del lib, x_csr, crow
    except (RuntimeError, NotImplementedError) as exc:
        note = f"torch.sparse.mm(Xᵀ, z) failed: {str(exc)[:200]}"
    torch.cuda.empty_cache()
    row = dict(
        name="spmm_xty", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:121", design=xdesign,
        deterministic=deterministic,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, err_f64=e64,
        tol_f64=F64_TOL,
        ms=time_ms(torch, lambda: spmm.spmm_xty(cols, vals, z, ncol=ncol)),
        plain_ms=time_ms(torch, lambda: ref.spmm_xty_ref(cols, vals, z, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=library_ms,
        library_note=note)
    finish(row, row["rel_err"], (("entry", e64),),
           ((deterministic, "two calls differ"),))
    del g, gp, g64

    # spmm_wgram: the sparse IRLS XᵀWX with weights in (0, 0.25].
    g = spmm.spmm_wgram(cols, vals, w, ncol=ncol)
    gp = ref.spmm_wgram_ref(cols, vals, w, ncol)
    g64 = ref.spmm_wgram_ref(cols, vals, w, ncol, torch.float64)
    d64, o64 = corr_err(torch, g, g64)
    b = bound(slab + n * 4 + ncol * ncol * 4, 2 * n * kmax * kmax + n * kmax)
    row = dict(
        name="spmm_wgram", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:168", design=design,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, diag_err_f64=d64,
        offdiag_err_f64=o64, tol_f64=F64_TOL,
        plain_f32_diag_offdiag_err_f64=corr_err(torch, gp, g64),
        ms=time_ms(torch, lambda: spmm.spmm_wgram(cols, vals, w, ncol=ncol),
                   reps=3),
        plain_ms=time_ms(torch,
                         lambda: ref.spmm_wgram_ref(cols, vals, w, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call computes XᵀWX on a sparse X")
    finish(row, row["rel_err"], (("diagonal", d64), ("off-diagonal", o64)))
    del g, gp, g64, w, z
    torch.cuda.empty_cache()
    return rows


def sparse_phase(torch, cols, vals, y):
    """Path c: sparse logistic regression and crossprod over the Criteo
    slab on cuda (counted), then cuda against torch on a prefix."""
    import numpy as np
    from repro_torch.algorithms import glm
    from repro_torch.core import fm
    Xs, Y = sparse_fm(cols, vals), fm.conv_R2FM(y)
    ncol = Xs.ncol

    def run():
        wall = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = glm(Xs, Y, "logistic", ridge=1e-3, max_iter=8)
        torch.cuda.synchronize()
        wall["glm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (G,) = fm.materialize(fm.crossprod(Xs))
        torch.cuda.synchronize()
        wall["crossprod"] = time.perf_counter() - t0
        return g, G, wall

    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (g, G, wall), launches = counted(
            torch, "sparse", ("spmm_gram", "spmm_xty", "spmm_wgram"), run)
    st = fm.exec_stats()
    check(st["passes"] == st["materialize_calls"],
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']}")
    t = np.array(g.loglik_trace)
    step = abs(t[-1] - t[-2]) / abs(t[-2]) if len(t) > 1 else 0.0
    check(np.isfinite(g.beta).all() and g.beta.shape == (ncol,), "glm beta")
    check((np.diff(t) > -1e-6 * np.abs(t[:-1])).all(),
          f"sparse glm log-likelihood fell: {t}")
    check(g.converged or step <= 1e-6, f"sparse glm did not converge: {t}")
    gd = fm._fm(G).logical_data()
    counts = torch.bincount(cols.reshape(-1).long(), minlength=ncol).float()
    block = torch.block_diag(*[torch.ones(CRITEO_BUCKETS, CRITEO_BUCKETS,
                                          device=gd.device)] * CRITEO_FACTORS)
    check(torch.equal(gd.diagonal(), counts), "crossprod diagonal is not the "
          "level counts")
    check(bool((gd * (block - torch.eye(ncol, device=gd.device)) == 0).all()),
          "crossprod has non-zero entries between levels of one column")
    emit({"phase": "main", "path": "sparse", "backend": "cuda",
          "wall_s": wall, "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"], "glm_iters": g.iters,
          "glm_converged": g.converged, "glm_loglik_trace": list(t),
          "rows": CRITEO_ROWS, "ncol": ncol,
          "slab_gib": (cols.nbytes + vals.nbytes) / 2**30})
    del G, gd, block

    m = SPARSE_CMP_ROWS
    Xp, Yp = sparse_fm(cols[:m], vals[:m]), fm.conv_R2FM(y[:m])
    fits, pwall = {}, {}
    for backend in ("cuda", "torch"):
        with fm.conf(backend=backend):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[backend] = glm(Xp, Yp, "logistic", ridge=1e-3, max_iter=8)
            torch.cuda.synchronize()
            pwall[backend] = time.perf_counter() - t0
    a, b = fits["cuda"], fits["torch"]
    # A one-hot design is rank-deficient — each column's 64 levels sum to
    # the same all-ones vector — so beta is fixed only up to that null space,
    # there by the tiny ridge alone, and float32 sums taken in another order
    # move it along it.  The linear predictor Xβ and the log-likelihood are
    # identifiable: those are compared.
    eta = [fm._fm(fm.materialize(Xp @ f.beta.astype(np.float32).reshape(
        -1, 1))[0]).logical_data() for f in (a, b)]
    eta_diff = float((eta[0] - eta[1]).abs().max())
    beta_diff = float(np.abs(a.beta - b.beta).max())
    ll_rel = abs(a.loglik - b.loglik) / abs(b.loglik)
    emit({"phase": "compare", "path": "sparse", "rows": m, "wall_s": pwall,
          "loglik": [a.loglik, b.loglik], "loglik_rel_diff": ll_rel,
          "eta_max_abs_diff": eta_diff, "beta_max_abs_diff": beta_diff})
    check(eta_diff < 1e-2, f"sparse glm linear predictor differs by "
          f"{eta_diff}")
    check(ll_rel < 1e-5, f"sparse glm log-likelihood differs by {ll_rel}")
    return launches


def flash_row(torch):
    """The flash kernel at the serving path's shape — B 4, 24 q heads over
    8 KV heads, S = T = 4096, head dim 128, bf16, causal — against its plain
    version (f32 math, a chunk of heads at a time) and float64 on a few
    heads, each within one bf16 rounding of the output, and in float32
    within 2e-3.

    The bf16 kernel computes in f32 and rounds once to bf16: at most half a
    bf16 ulp, 2^-8·|o|, off the f32 plain version's unrounded output.  It
    is held to 2e-3 + 1e-2·|o| of that (2.5 times the rounding, room for
    f32 sums in another order) and to 1e-5 + 2^-7·|o| of float64 (one ulp
    or more).  The JAX tests' atol = rtol = 3e-2 would pass nearly any
    output at this shape, where a typical |o| is about 0.03."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, flash_attention as fa, ref
    cfg = get_config(LM_ARCH)
    B, nh, nkv, S, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, cfg.hd
    g = nh // nkv
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 4)
    q = torch.randn((B, nh, S, d), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, nkv, S, d), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    o = fa.flash_attention(q, k, v, causal=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    pf = ref.flash_attention_ref(qf, kf, vf, causal=True)   # f32, unrounded
    diff = (o.float() - pf).abs()
    excess = float((diff - 2e-3 - 1e-2 * pf.abs()).max())
    err64 = excess64 = -float("inf")
    for b, h in ((0, 0), (B // 2, g + 1), (B - 1, nh - 1)):
        o64 = ref.flash_attention_ref(qf[b:b + 1, h:h + 1].double(),
                                      kf[b:b + 1, h // g:h // g + 1].double(),
                                      vf[b:b + 1, h // g:h // g + 1].double(),
                                      causal=True, dtype=torch.float64)[0, 0]
        d64 = (o[b, h].double() - o64).abs()
        err64 = max(err64, float(d64.max()))
        excess64 = max(excess64,
                       float((d64 - 1e-5 - 2.0 ** -7 * o64.abs()).max()))
    of = fa.flash_attention(qf, kf, vf, causal=True)
    excess32 = float(((of - pf).abs() - 2e-3 - 2e-3 * pf.abs()).max())
    ops = 2 * B * nh * S * S * d                  # causal: half of 4·B·nh·S²·d
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v once, bf16
    b = bound(nbytes, ops, BF16_FLOP_S)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:101",
        shape=f"q ({B}, {nh}, {S}, {d}), k/v ({B}, {nkv}, {S}, {d}) bf16, "
              "causal",
        body=fa.body_for(q.dtype, d), f32_body=fa.body_for(qf.dtype, d),
        ptxas=build.ptxas_report("flash_attention",
                                 f"flash_fwd_wgmmaILi{d}ELb1E"),
        max_abs_err=float(diff.max()),
        tol="|o - plain| <= 2e-3 + 1e-2·|plain|, plain the f32 plain version",
        tol_excess=excess, max_abs_err_f64=err64,
        tol_f64="|o - o64| <= 1e-5 + 2^-7·|o64| (one bf16 ulp)",
        tol_f64_excess=excess64,
        f32_max_abs_err=float((of - pf).abs().max()),
        f32_tol="atol = rtol = 2e-3", f32_tol_excess=excess32,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True)),
        f32_ms=time_ms(torch, lambda: fa.flash_attention(qf, kf, vf,
                                                         causal=True)),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True), reps=2),
        bound_ms=b[0], bound_by=b[1], bound_rate="bf16 tensor, 989 TFLOP/s",
        design_bound_ms=1.5 * ops / BF16_FLOP_S * 1e3,
        design_bound_note="the wgmma body's QKᵀ plus P·V as two products "
                          "(P split into bf16 hi + lo): 1.5× the operations",
        bound_f32_ms=ops / F32_FLOP_S * 1e3, ops=ops, bytes=nbytes,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        library="torch.nn.functional.scaled_dot_product_attention("
                "is_causal=True, enable_gqa=True)")
    row["d112"] = flash_d112(torch)
    emit({"phase": "kernel", **row})
    check(row["d112"]["tol_excess"] <= 0, "flash_attention at head dim 112 "
          "exceeds 2e-3 + 1e-2·|plain| of the f32 plain version by "
          f"{row['d112']['tol_excess']}")
    check(excess <= 0, f"flash_attention bf16 exceeds 2e-3 + 1e-2·|plain| "
          f"of the f32 plain version by {excess}")
    check(excess64 <= 0, f"flash_attention bf16 exceeds one bf16 ulp of "
          f"float64 by {excess64}")
    check(excess32 <= 0, f"flash_attention f32 exceeds atol = rtol = 2e-3 "
          f"of the plain version by {excess32}")
    del q, k, v, o, diff, qf, kf, vf, of, pf
    torch.cuda.empty_cache()
    return row


def flash_d112(torch):
    """Head dim 112 (zamba2-7b's attention: 32 heads, no GQA), bf16, causal,
    S = T = 4096 on the FMA body, against the f32 plain version under the
    serving row's rule; its time is printed, not checked."""
    from repro_torch.kernels import build, flash_attention as fa, ref
    B, nh, S, d = 1, 32, LM_PROMPT, 112
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 5)
    q, k, v = (torch.randn((B, nh, S, d), generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    pf = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    diff = (o.float() - pf).abs()
    out = dict(shape=f"q, k, v ({B}, {nh}, {S}, {d}) bf16, causal",
               body=fa.body_for(q.dtype, d), max_abs_err=float(diff.max()),
               tol_excess=float((diff - 2e-3 - 1e-2 * pf.abs()).max()),
               ms=time_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                            causal=True)),
               ptxas=build.ptxas_report("flash_attention",
                                        f"flash_fwdI13__nv_bfloat16Li{d}E"))
    del q, k, v, o, pf, diff
    return out


def lm_phase(torch, flash_ms):
    """Path d: llama3.2-3b prefill + greedy decode on the card, counted,
    then checks (a)-(d)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = get_config(LM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    resident = torch.cuda.memory_allocated()
    model = steps.serving_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in zoo.flatten(params))
    max_len = S + LM_DECODE
    prefill = steps.build_prefill_step(model, max_len)
    decode = steps.build_decode_step(model)
    batch = {"tokens": toks[:, :S]}
    prefill(params, batch)                       # warm: cuBLAS, the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        cache, logits = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs, tok = [logits], logits.argmax(-1).to(torch.int32)
        for _ in range(LM_DECODE):
            cache, logits = decode(params, cache, tok)
            outs.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        return outs, t1 - t0, time.perf_counter() - t1

    (outs, pre_s, dec_s), launches = counted(
        torch, "lm", ("flash_attention",), run)
    peak = torch.cuda.max_memory_allocated()
    greedy = torch.stack([o.argmax(-1)[:, 0] for o in outs], 1)
    emit({"phase": "main", "path": "lm", "arch": LM_ARCH,
          "n_params": n_params, "param_dtype": "bfloat16",
          "init_s": init_s, "batch": B, "prompt": S, "decode_steps": LM_DECODE,
          "prefill_ms": pre_s * 1e3, "prefill_tokens_s": B * S / pre_s,
          "decode_ms_per_step": dec_s * 1e3 / LM_DECODE,
          "decode_tokens_s": B * LM_DECODE / dec_s,
          "flash_launches": launches["flash_attention"],
          "flash_share_of_prefill": cfg.n_layers * flash_ms / (pre_s * 1e3),
          "max_memory_allocated": peak, "max_memory_gib": peak / 2**30,
          "resident_before_gib": resident / 2**30,
          "kv_cache_gib": 2 * cfg.n_layers * B * max_len * cfg.n_kv_heads
          * cfg.hd * 2 / 2**30,
          "greedy_tokens_row0": greedy[0].tolist()})
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in "
          f"one prefill, not once per layer ({cfg.n_layers})")

    def a_and_b(model_, params_):
        """(a) last-position logits of the kernel prefill against the same
        prefill with the plain attention; (b) prefill + one decode step
        against a prefill one token longer.  Both at the main shape."""
        pre = steps.build_prefill_step(model_, max_len)
        cache, got = pre(params_, batch)
        _, want = steps.build_prefill_step(model_, max_len, attn_impl="ref")(
            params_, batch)
        _, dec = steps.build_decode_step(model_)(params_, cache,
                                                 toks[:, S:S + 1])
        del cache
        _, full = pre(params_, {"tokens": toks})
        logits = [got, want, dec, full]
        return rel_err(torch, got, want), rel_err(torch, dec, full), logits

    # In bf16 both read the rounding noise of these random weights (printed
    # only); the checks run on the same weights and activations in float32.
    a16, b16, logits16 = a_and_b(model, params)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = zoo.tree_map(lambda _, t: t.float(), params)
    del params
    a, b, logits32 = a_and_b(zoo.build(cfg32, DEVICE), params32)
    finite = all(bool(torch.isfinite(t).all())
                 for t in outs + logits16 + logits32)
    emit({"phase": "compare", "path": "lm", "dtype": "float32",
          "batch": B, "prompt": S,
          "a_kernel_vs_plain_prefill": a, "a_tol": LM_F32_TOL,
          "b_prefill_decode_vs_longer_prefill": b, "b_tol": LM_F32_TOL,
          "c": "(a) in float32, which (a) is",
          "d_all_logits_finite": finite,
          "a_bf16_not_checked": a16, "b_bf16_not_checked": b16})
    check(a < LM_F32_TOL, f"lm (a): float32 kernel prefill vs plain {a}")
    check(b < LM_F32_TOL, f"lm (b): float32 prefill + decode vs longer "
          f"prefill {b}")
    check(finite, "lm (d): a logit is not finite")
    del params32, outs, logits16, logits32
    torch.cuda.empty_cache()
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

    x, y, xk, lab = make_data(torch)
    emit({"phase": "data", "shape": [N_ROWS, N_COLS], "dtype": "float32",
          "gib": x.numel() * 4 / 2**30, "seed": SEED})
    rows = kernel_phase(torch, x, xk)
    small_phase(x, xk, lab)
    paths = [main_phase(torch, x, y, xk),
             algorithms_phase(torch, x, xk, lab)]
    from repro_torch.core import materialize
    materialize.clear_plan_cache()   # cached plans hold their sources
    del x, y, xk, lab
    gc.collect()                     # reference cycles in the engine hold them
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols, vals, ys = make_criteo(torch)
    emit({"phase": "data", "shape": [CRITEO_ROWS, CRITEO_FACTORS],
          "ncol": CRITEO_FACTORS * CRITEO_BUCKETS, "zipf_s": ZIPF_S,
          "slab_gib": (cols.nbytes + vals.nbytes) / 2**30, "seed": SEED,
          "seconds": time.perf_counter() - t0})
    rows += spmm_rows(torch, cols, vals)
    paths.append(sparse_phase(torch, cols, vals, ys))
    materialize.clear_plan_cache()   # cached plans hold the slab
    del cols, vals, ys
    gc.collect()
    torch.cuda.empty_cache()

    rows.append(flash_row(torch))
    paths.append(lm_phase(torch, rows[-1]["ms"]))
    for r in rows:
        r["launches"] = sum(p[r["name"]] for p in paths)
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
