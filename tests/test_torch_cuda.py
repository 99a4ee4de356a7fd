"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a CUDA device and skips
without one (this is decided at run time, never at import).  On a machine
with a card and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes cover ragged row counts, column counts below, at and across the
32-wide tiles, bf16 sources, every chain unary, integer accumulators, NaN
and all-negative min/max edges, more chains than one launch takes,
k-means layouts whose centers or row tile do not fit in shared memory, xty
at thin and wide second operands, and ELL slabs with padding rows,
duplicate columns, kmax = 1 and kmax past one 32-entry mask window, over
one and many output tiles.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fused_apply_agg as faa, gram as gram_mod,
                                 kmeans_assign as ka, ref, spmm,
                                 weighted_gram as wg)

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x(n, p, dtype, dev, scale=1.0):
    return torch.as_tensor(RNG.normal(size=(n, p)) * scale,
                           dtype=torch.float32).to(dtype).to(dev)


def _close(a, b, tol):
    a, b = a.double().cpu(), b.double().cpu()
    scale = max(float(b.abs().max()), 1.0)
    assert float((a - b).abs().max()) <= tol * scale


def _close_gram(g, x, w=None):
    """Entry by entry against the float64 plain version, in the units of a
    correlation (|ΔG_ij| / sqrt(G_ii·G_jj)); off-diagonal entries, whose
    terms take both signs and round far less, to a tighter limit."""
    x64 = x.double()
    g64 = (x64 if w is None else x64 * w.double()[:, None]).T @ x64
    d = g64.diagonal().clamp_min(1e-300).sqrt()
    err = (g.double() - g64).abs() / torch.outer(d, d)
    assert float(err.diagonal().max()) <= 1e-5
    off = ~torch.eye(err.shape[0], dtype=torch.bool, device=err.device)
    if off.any():
        assert float(err[off].max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 100, 1000, 70001])
@pytest.mark.parametrize("p", [1, 7, 12, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_and_wgram(dev, n, p, dtype):
    x = _x(n, p, dtype, dev)
    w = torch.rand(n, device=dev)
    before = (gram_mod.launches, wg.launches)
    _close_gram(gram_mod.gram(x), x)
    _close_gram(wg.wgram(x, w), x, w)
    _close_gram(wg.wgram(x, w.reshape(-1, 1)), x, w)
    torch.cuda.synchronize()
    assert (gram_mod.launches, wg.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("n", [1, 1000, 70001])
@pytest.mark.parametrize("p,q", [(8, 32), (32, 1), (33, 70), (1, 1),
                                 (16, 40), (40, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xty(dev, n, p, q, dtype):
    x, y = _x(n, p, dtype, dev), _x(n, q, dtype, dev)
    before = gram_mod.xty_launches
    got = gram_mod.xty(x, y)
    want = x.double().T @ y.double()
    torch.cuda.synchronize()
    assert gram_mod.xty_launches == before + 1 and got.shape == (p, q)
    # entry by entry in the units of sqrt(Σx_i² · Σy_j²)
    scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                        y.double().pow(2).sum(0).sqrt()).clamp_min(1e-300)
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5


def _ell(n, kmax, ncol, dev, dtype=torch.float32):
    """A random slab with all-padding rows, rows with padding at the end and
    duplicate columns inside rows."""
    cols = torch.as_tensor(RNG.integers(0, ncol, size=(n, kmax)),
                           dtype=torch.int32)
    vals = torch.as_tensor(RNG.uniform(0.5, 1.5, size=(n, kmax)),
                           dtype=torch.float32)
    pad = torch.as_tensor(RNG.uniform(size=(n, kmax)) < 0.2)
    pad[::7] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if kmax > 1 and n > 3:
        cols[3, 1] = cols[3, 0]
    return cols.to(dev), vals.to(dtype).to(dev)


@pytest.mark.parametrize("n", [1, 255, 5000])
@pytest.mark.parametrize("kmax,ncol", [(1, 5), (3, 23), (26, 300), (40, 1664)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm(dev, n, kmax, ncol, dtype):
    cols, vals = _ell(n, kmax, ncol, dev, dtype)
    w = torch.rand(n, device=dev) * 0.25
    y = _x(n, 3, torch.float32, dev)
    before = (spmm.gram_launches, spmm.xty_launches, spmm.wgram_launches)
    got = (spmm.spmm_gram(cols, vals, ncol=ncol),
           spmm.spmm_xty(cols, vals, y, ncol=ncol),
           spmm.spmm_wgram(cols, vals, w.reshape(-1, 1), ncol=ncol))
    want = (ref.spmm_gram_ref(cols, vals, ncol, torch.float64),
            ref.spmm_xty_ref(cols, vals, y, ncol, torch.float64),
            ref.spmm_wgram_ref(cols, vals, w, ncol, torch.float64))
    torch.cuda.synchronize()
    assert (spmm.gram_launches, spmm.xty_launches, spmm.wgram_launches) == \
        tuple(b + 1 for b in before)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == torch.float32
        _close(g, r, 1e-5)


@pytest.mark.parametrize("q", [1, 40])
def test_spmm_criteo_layout(dev, q):
    """The main path's tiling (ncol = 1664, kmax = 26: 36 triangle tiles, two
    threads a row, xty in one or several column stripes) on 20,000 rows."""
    cols = torch.as_tensor(
        RNG.integers(0, 64, size=(20000, 26)) + 64 * np.arange(26),
        dtype=torch.int32).to(dev)
    vals = torch.ones(cols.shape, device=dev)
    w = torch.rand(20000, device=dev) * 0.25
    y = _x(20000, q, torch.float32, dev)
    _close(spmm.spmm_gram(cols, vals, ncol=1664),
           ref.spmm_gram_ref(cols, vals, 1664, torch.float64), 1e-6)
    _close(spmm.spmm_wgram(cols, vals, w, ncol=1664),
           ref.spmm_wgram_ref(cols, vals, w, 1664, torch.float64), 1e-5)
    _close(spmm.spmm_xty(cols, vals, y, ncol=1664),
           ref.spmm_xty_ref(cols, vals, y, 1664, torch.float64), 1e-5)


_ALL_UNARY_CHAINS = tuple(((u,), "sum", "float32")
                          for u in faa.CHAIN_UNARIES
                          if u not in ("log", "sqrt", "log1p"))


@pytest.mark.parametrize("n", [1, 257, 5000])
@pytest.mark.parametrize("p", [1, 12, 32, 45])
def test_fused_apply_agg_float_chains(dev, n, p):
    x = _x(n, p, torch.float32, dev, scale=3.0)
    xa = x.abs() + 0.5          # domain of log/sqrt/log1p
    chains = ref.SUMMARY_CHAINS + _ALL_UNARY_CHAINS
    for src, spec in ((x, chains),
                      (xa, ((("log",), "sum"), (("sqrt", "exp"), "max"),
                            (("log1p", "round"), "min")))):
        spec = faa.normalize_chains(spec)
        got = faa.fused_apply_agg(src, spec)
        want = ref.fused_apply_agg_ref(src, spec)
        for (u, agg, _), a, b in zip(spec, got, want):
            if agg in ("min", "max", "count", "count_nonzero"):
                assert torch.equal(a, b), (u, agg)
            else:
                _close(a, b, 1e-5)


def test_fused_apply_agg_int_and_cast_chains(dev):
    a = torch.as_tensor(RNG.integers(-50, 50, size=(3001, 5)),
                        dtype=torch.int32).to(dev)
    a[0, 0] = (1 << 24) + 1     # not representable in float32
    chains = ((("sq",), "sum", "int32"), ((), "max", "int32"),
              ((), "min", "int32"), (("abs", "neg"), "sum", "int32"),
              (("abs", "cast_float32", "sqrt"), "sum", "float32"),
              (("abs", "sqrt"), "max", "int32"), (("cast_bfloat16", "sq"), "sum",
                                            "float32"),
              ((), "count", "int32"), ((), "count_nonzero", "int32"))
    got = faa.fused_apply_agg(a, chains)
    want = ref.fused_apply_agg_ref(a, faa.normalize_chains(chains))
    for (u, agg, acc), g, w in zip(chains, got, want):
        assert g.dtype == w.dtype
        if acc == "int32":
            assert torch.equal(g, w), (u, agg)
        else:
            _close(g, w, 1e-5)
    assert int(got[1][0]) == (1 << 24) + 1


def test_fused_apply_agg_nan_negative_and_narrow_sources(dev):
    x = -torch.rand(700, 4, device=dev) - 1.0     # all negative
    x[3, 1] = float("nan")
    mx, mn, s = faa.fused_apply_agg(x, (((), "max"), ((), "min"),
                                        ((), "sum")))
    assert torch.isnan(mx[1]) and torch.isnan(mn[1]) and torch.isnan(s[1])
    keep = [0, 2, 3]
    assert torch.equal(mx[keep], x[:, keep].amax(0))
    assert torch.equal(mn[keep], x[:, keep].amin(0))
    x8 = torch.as_tensor(RNG.integers(-100, 100, size=(999, 3)),
                         dtype=torch.int8).to(dev)
    (s8,) = faa.fused_apply_agg(x8, (((), "sum", "int32"),))
    assert torch.equal(s8, x8.to(torch.int32).sum(0, dtype=torch.int32))
    chains = faa.normalize_chains(ref.SUMMARY_CHAINS + (
        (("sq",), "count_nonzero", "int32"), (("exp",), "sum"),
        (("abs",), "max", "int32")))
    for dtype in (torch.bfloat16, torch.float16):   # read in the kernel / widened first
        xb = _x(999, 6, dtype, dev)
        for (u, agg, _), g, w in zip(chains, faa.fused_apply_agg(xb, chains),
                                     ref.fused_apply_agg_ref(faa._widen(xb),
                                                             chains)):
            if agg in ("min", "max", "count_nonzero"):
                assert torch.equal(g, w), (dtype, u, agg)
            else:
                _close(g, w, 1e-4)


def _check_lloyd(x, c):
    lab, sums, cnts, wss = ka.kmeans_assign(x, c)
    rl, rs, rc, rw = ref.kmeans_assign_ref(x, c)
    bad = (lab != rl).nonzero().reshape(-1)
    if bad.numel():
        xb, cd = x[bad].double(), c.double()
        da = ((xb - cd[lab[bad].long()]) ** 2).sum(1)
        dr = ((xb - cd[rl[bad].long()]) ** 2).sum(1)
        assert bool(((da - dr).abs()
                     <= 1e-5 * torch.maximum(da, dr).clamp_min(1.0)).all())
    assert float((cnts - rc).abs().sum()) <= 2 * bad.numel()
    _close(sums, rs, 1e-4)
    _close(wss, rw, 1e-4)


@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("k,p", [(2, 3), (5, 8), (10, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign(dev, n, k, p, dtype):
    x = _x(n, p, dtype, dev)
    c = _x(k, p, torch.float32, dev)
    _check_lloyd(x, c)


@pytest.mark.parametrize("k,p", [(900, 64), (3, 300), (60000, 1)])
def test_kmeans_assign_global_layouts(dev, k, p):
    """Centers (900·64·4 B), the row tile (256·301·4 B) or even ‖c‖²
    (60000·4 B) too large for shared memory: read from global memory
    instead, same results."""
    x = _x(3000, p, torch.float32, dev)
    c = _x(k, p, torch.float32, dev)
    _check_lloyd(x, c)


def test_engine_reaches_every_kernel_on_cuda(dev):
    """The four algorithms on the card with backend cuda launch each kernel
    and agree with backend torch."""
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    X = (RNG.normal(size=(20000, 8)) * 2 + 1).astype(np.float32)
    beta = RNG.uniform(-1, 1, 8)
    y = (RNG.uniform(size=20000) < 1 / (1 + np.exp(-(X - 1) @ beta))
         ).astype(np.float32)
    mods = (gram_mod, wg, faa, ka)
    res = {}
    with fm.conf(device="cuda"):
        for backend in ("cuda", "torch"):
            before = [m.launches for m in mods]
            with fm.conf(backend=backend):
                Xf, yf = fm.conv_R2FM(X), fm.conv_R2FM(y)
                res[backend] = (summary(Xf), correlation(Xf),
                                glm(Xf, yf, max_iter=8),
                                kmeans(Xf, k=4, max_iter=3))
            grew = [m.launches > b for m, b in zip(mods, before)]
            assert all(grew) if backend == "cuda" else not any(grew)
    s, c, g, k = res["cuda"]
    s2, c2, g2, k2 = res["torch"]
    np.testing.assert_allclose(s.mean, s2.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.col_min, s2.col_min)
    np.testing.assert_allclose(c, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.beta, g2.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(k.wss, k2.wss, rtol=1e-3)


def test_engine_reaches_xty_and_spmm_on_cuda(dev):
    """NMF and GMM reach xty (and gram, wgram), sparse logistic regression
    and crossprod over a one-hot design reach the three SpMM kernels; each
    agrees with backend torch."""
    from repro_torch.algorithms import glm, gmm, nmf
    from repro_torch.core import fm
    centers = RNG.normal(size=(3, 6)) * 8
    X = np.concatenate([c + RNG.normal(size=(3000, 6)) for c in centers]
                       ).astype(np.float32)
    codes = [RNG.integers(0, lv, 9000) for lv in (7, 5, 11)]
    yb = (RNG.uniform(size=9000) < 0.3).astype(np.float32)
    counters = ((gram_mod, "xty_launches"), (spmm, "gram_launches"),
                (spmm, "xty_launches"), (spmm, "wgram_launches"))
    res = {}
    with fm.conf(device="cuda"):
        for backend in ("cuda", "torch"):
            before = [getattr(m, a) for m, a in counters]
            with fm.conf(backend=backend):
                Xf = fm.conv_R2FM(X)
                Xs = fm.one_hot(*[fm.as_factor(c) for c in codes], host=False)
                (G,) = fm.materialize(fm.crossprod(Xs))
                res[backend] = (nmf(fm.conv_R2FM(np.abs(X)), k=3,
                                    max_iter=4),
                                gmm(Xf, k=3, max_iter=4, seed=1),
                                glm(Xs, fm.conv_R2FM(yb), ridge=1e-3),
                                fm.as_np(G))
            grew = [getattr(m, a) > b for (m, a), b in zip(counters, before)]
            assert all(grew) if backend == "cuda" else not any(grew)
    (n1, g1, l1, G1), (n2, g2, l2, G2) = res["cuda"], res["torch"]
    np.testing.assert_allclose(n1.objective_trace, n2.objective_trace,
                               rtol=1e-4)
    np.testing.assert_allclose(g1.loglik_trace, g2.loglik_trace, rtol=1e-5)
    np.testing.assert_allclose(l1.loglik, l2.loglik, rtol=1e-5)
    np.testing.assert_array_equal(G1, G2)
