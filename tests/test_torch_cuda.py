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
duplicate columns, kmax = 1 and kmax past one 32-entry chunk (up to
20,000), negative values and rows of weight 0, over one and many output
tiles, spmm_xty held to float64 exactly and bit for bit from call to call;
wgram's triangle body (p ≤ 32) and tile body (p > 32) told apart by their
launch counters, from bases off 16 bytes too; xty's thin path at every
narrow width 1..16;
flash attention over ragged S and T (S below, equal to and above T), every
head dim the kernel is built for (80, 96, 112 and 256 among them), GQA
group factors 1, 3 and 8, causal and not, bf16 (held within one bf16 ulp
of float64) and f32, the wgmma body over many kv tiles, zero and negative
scales, unaligned bases (copied, then equal to the aligned result),
one case whose element offsets pass 2³¹, and a reduced LM prefill and
decode on the card against the same on the CPU; xty's 16-byte loads over
a ragged last column tile at the end of whole allocator segments.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention as fa,
                                 fused_apply_agg as faa, gram as gram_mod,
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


@pytest.mark.parametrize("n", [1, 3, 1000, 70001])
@pytest.mark.parametrize("p", [1, 7, 12, 31, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgram_bodies(dev, n, p, dtype):
    """wgram's triangle body (p ≤ 32: bulk-copied chunks, a plain-loaded
    tail chunk, 8×8 tiles of the upper triangle) and the tile body (p > 32),
    told apart by the launch counters, against float64 in correlation
    units; X and w views whose bases are off a 16-byte boundary are copied
    first and give the aligned result bit for bit; the triangle body's
    result is its own mirror, exactly."""
    x = _x(n, p, dtype, dev)
    w = torch.rand(n, device=dev)
    x_off = _x(n * p + 1, 1, dtype, dev).reshape(-1)[1:].reshape(n, p)
    w_off = torch.rand(n + 1, device=dev)[1:]
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    tri = p <= gram_mod.TRI_MAX_P
    before = (wg.launches, wg.tri_launches)
    got = wg.wgram(x, w)
    off = wg.wgram(x_off, w_off)
    again = wg.wgram(x_off.clone(), w_off.clone())
    torch.cuda.synchronize()
    assert (wg.launches, wg.tri_launches) == (before[0] + 3,
                                              before[1] + 3 * tri)
    _close_gram(got, x, w)
    _close_gram(off, x_off, w_off)
    assert torch.equal(off, again)
    assert torch.equal(got, got.T) or not tri


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


@pytest.mark.parametrize("na", range(1, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xty_thin_widths(dev, na, dtype):
    """The thin path at every narrow width 1..16 (each served by the built
    width thin_width(na)), as X and as Y, over wide operands of 32 columns
    (16-byte loads) and 37 (scalar loads), for n below one block step (32
    rows), across a few and not a multiple of the rows a block prefetches,
    and from a base that is not 16-byte aligned; entry by entry against
    float64 in the units of sqrt(Σx_i² · Σy_j²)."""
    for n in (5, 1000, 70001):
        for nw in (32, 37):
            narrow = _x(n, na, dtype, dev)
            wide = _x(n * nw + 1, 1, dtype, dev).reshape(-1)[1:].reshape(n, nw)
            for x, y in ((narrow, wide), (wide, narrow)):
                before = gram_mod.xty_launches
                got = gram_mod.xty(x, y)
                torch.cuda.synchronize()
                assert gram_mod.xty_launches == before + 1
                want = x.double().T @ y.double()
                scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                                    y.double().pow(2).sum(0).sqrt())
                err = (got.double() - want).abs() / scale.clamp_min(1e-300)
                assert got.shape == want.shape and float(err.max()) <= 1e-5


@pytest.mark.parametrize("nw", [36, 40, 44])
@pytest.mark.parametrize("na", [1, 8])
def test_xty_thin_vector_loads_stop_at_the_last_column(dev, nw, na):
    """The thin path's 16-byte loads with nw a multiple of 4 but not of 32:
    the last column tile is ragged, its threads past nw load nothing.  The
    wide operand is 131,072 rows, 18, 20 or 22 MiB: whole 2 MiB segments of
    the caching allocator, so a read past its end would leave its
    allocation."""
    n = 131_072
    assert (n * nw * 4) % (2 << 20) == 0
    narrow, wide = _x(n, na, torch.float32, dev), _x(n, nw, torch.float32, dev)
    for x, y in ((narrow, wide), (wide, narrow)):
        before = gram_mod.xty_launches
        got = gram_mod.xty(x, y)
        torch.cuda.synchronize()
        assert gram_mod.xty_launches == before + 1
        want = x.double().T @ y.double()
        scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                            y.double().pow(2).sum(0).sqrt())
        err = (got.double() - want).abs() / scale.clamp_min(1e-300)
        assert got.shape == want.shape and float(err.max()) <= 1e-5


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


@pytest.mark.parametrize("kmax", [1, 3, 26, 33, 40, 20000])
def test_spmm_gram_warp_per_row_body(dev, kmax):
    """The gram / wgram body over one 32-entry chunk, a chunk and a bit, and
    625 chunks a row (kmax = 20,000, wider than xty's staging takes): 64
    rows, ncol = 1,664 (28 tiles), duplicate columns, negative values, and
    rows of weight 0, against the float64 plain version."""
    n, ncol = 64, 1664
    cols, vals = _ell(n, kmax, ncol, dev)
    cols[5, :64] = int(cols[5, 0])              # one column, up to 64 times
    # Values in ±{0.5, 1, 1.5}: every f32 partial sum is exact, so the
    # kernel must hit float64 whatever the order of its atomics.
    vals = (vals * 2).round() / 2 * torch.where(
        torch.rand(vals.shape, device=dev) < 0.3, -1.0, 1.0)
    w = torch.rand(n, device=dev)
    w[::3] = 0.0
    before = (spmm.gram_launches, spmm.wgram_launches)
    got = (spmm.spmm_gram(cols, vals, ncol=ncol),
           spmm.spmm_wgram(cols, vals, w, ncol=ncol))
    torch.cuda.synchronize()
    assert (spmm.gram_launches, spmm.wgram_launches) == tuple(
        b + 1 for b in before)
    for g, r in zip(got, (ref.spmm_gram_ref(cols, vals, ncol, torch.float64),
                          ref.spmm_wgram_ref(cols, vals, w, ncol,
                                             torch.float64))):
        assert g.shape == (ncol, ncol) and g.dtype == torch.float32
        _close(g, r, 1e-5)


def _halves(shape, dev):
    """Values in ±{0.5, 1, 1.5}: products and sums of a few thousand of
    them are exact in f32, whatever the order."""
    v = torch.as_tensor(RNG.integers(1, 4, size=shape) / 2.0,
                        dtype=torch.float32)
    return (v * torch.where(torch.as_tensor(RNG.uniform(size=shape)) < 0.3,
                            -1.0, 1.0)).to(dev)


@pytest.mark.parametrize("kmax", [1, 3, 26, 33, 40, 20000])
@pytest.mark.parametrize("q", [1, 3, 32])
def test_spmm_xty_warp_per_row_body(dev, kmax, q):
    """The xty body over one 32-entry chunk, a chunk and a bit, and 625
    chunks a row (kmax = 20,000, which the old staged body could not take),
    ncol = 1,664: even rows one-hot-like (each 32-entry chunk distinct
    columns in increasing order, some padded at the end: the vote's fast
    path), odd rows drawn at random (unsorted, duplicate columns: the
    __match_any_sync path), one row a single column up to 64 times, padding
    between entries, negative values.  Every product and partial sum is
    exact in f32, so the kernel must equal float64, and two calls must be
    equal bit for bit."""
    n, ncol = (64 if kmax > 40 else 3000), 1664
    cols = torch.as_tensor(RNG.integers(0, ncol, size=(n, kmax)),
                           dtype=torch.int32)
    for r in range(0, n, 2):
        for a0 in range(0, kmax, 32):
            k = min(32, kmax - a0)
            cols[r, a0:a0 + k] = torch.as_tensor(
                np.sort(RNG.choice(ncol, size=k, replace=False)))
    vals = _halves((n, kmax), "cpu")
    tail = torch.as_tensor(RNG.uniform(size=n) < 0.3)[:, None] & (
        torch.arange(kmax) >= max(1, kmax - 5))
    mid = torch.as_tensor(RNG.uniform(size=(n, kmax)) < 0.05)
    mid[::2] = False
    pad = tail | mid
    cols[pad] = 0
    vals[pad] = 0.0
    cols[5, :64] = int(cols[5, 0])              # one column, up to 64 times
    cols, vals = cols.to(dev), vals.to(dev)
    y = _halves((n, q), dev)
    before = spmm.xty_launches
    got = spmm.spmm_xty(cols, vals, y, ncol=ncol)
    again = spmm.spmm_xty(cols, vals, y, ncol=ncol)
    torch.cuda.synchronize()
    assert spmm.xty_launches == before + 2
    want = ref.spmm_xty_ref(cols, vals, y, ncol, torch.float64)
    assert got.shape == (ncol, q) and got.dtype == torch.float32
    assert torch.equal(got.double(), want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("q", [1, 40])
def test_spmm_criteo_layout(dev, q):
    """The main path's tiling (ncol = 1664, kmax = 26: 28 triangle tiles of
    240, a warp a row; xty in one or several column stripes) on 20,000
    rows."""
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


_ATTN_LENGTHS = [(1, 1), (37, 37), (100, 100), (130, 70), (70, 200),
                 (257, 257)]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, d, g, causal, dtype):
    """Against the float64 plain version (the Pallas kernel's function: top-
    left causal mask by absolute ids): f32 within 1e-4 of max(|O|, 1), bf16
    within 1e-2 (one bf16 rounding of the output)."""
    B, nkv = 2, 2
    for S, T in _ATTN_LENGTHS:
        q = _x(B * nkv * g * S, d, dtype, dev).reshape(B, nkv * g, S, d)
        k = _x(B * nkv * T, d, dtype, dev).reshape(B, nkv, T, d)
        v = _x(B * nkv * T, d, dtype, dev).reshape(B, nkv, T, d)
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       dtype=torch.float64)
        _close(got, want, 1e-4 if dtype == torch.float32 else 1e-2)
        if dtype == torch.bfloat16:
            _within_one_ulp(got, want)


def _within_one_ulp(got, want):
    """bf16 output within one bf16 ulp, 1e-5 + 2⁻⁷·|o64|, of the float64
    plain version, element by element (chip_smoke.py's rule): a kernel that
    rounded P to bf16 once would miss it."""
    want = want.double().cpu()
    excess = (got.double().cpu() - want).abs() - 1e-5 - 2.0 ** -7 * want.abs()
    assert float(excess.max()) <= 0


@pytest.mark.parametrize("S,T,d,g,causal", [
    (1024, 1024, 128, 3, True), (1024, 1024, 128, 3, False),
    (1024, 1024, 64, 3, True), (1000, 1000, 128, 1, True),
    (300, 1000, 64, 8, False), (50, 50, 128, 3, True), (50, 300, 64, 1, False),
    (200, 130, 128, 3, True)])
def test_flash_attention_hopper_body(dev, S, T, d, g, causal):
    """The wgmma body (bf16, head dims 64 and 128) across many kv tiles and
    wrap-arounds of its ring (2 stages at d 128, 4 at d 64; T = 1024 is 8
    tiles of 128 keys), T not a multiple of the 128-key tile, S below one
    64-row warpgroup and below the 128-row block: one launch, within one
    bf16 ulp of float64."""
    assert fa.body_for(torch.bfloat16, d) == "wgmma"
    B, nkv = 2, 2
    q = _x(B * nkv * g * S, d, torch.bfloat16, dev).reshape(B, nkv * g, S, d)
    k = _x(B * nkv * T, d, torch.bfloat16, dev).reshape(B, nkv, T, d)
    v = _x(B * nkv * T, d, torch.bfloat16, dev).reshape(B, nkv, T, d)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   dtype=torch.float64)
    _close(got, want, 1e-2)
    _within_one_ulp(got, want)


def test_flash_attention_matched_heads_and_scale(dev):
    """The Pallas kernel's own layout (BH, S, D) and an explicit scale."""
    q = _x(3 * 150, 64, torch.float32, dev).reshape(3, 150, 64)
    k = _x(3 * 90, 64, torch.float32, dev).reshape(3, 90, 64)
    v = _x(3 * 90, 64, torch.float32, dev).reshape(3, 90, 64)
    for causal in (True, False):
        _close(fa.flash_attention(q, k, v, causal=causal, scale=0.3),
               ref.flash_attention_ref(q, k, v, causal=causal, scale=0.3,
                                       dtype=torch.float64), 1e-4)


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (64, torch.bfloat16),
                                     (32, torch.bfloat16), (64, torch.float32)])
@pytest.mark.parametrize("scale", [0.0, -0.3])
def test_flash_attention_zero_and_negative_scale(dev, d, dtype, scale):
    """Both bodies mask after the scale: at scale 0 a row averages its
    unmasked values, at a negative scale the masked keys still drop out;
    bf16 within one bf16 ulp of float64, f32 within 1e-4."""
    B, nh, nkv, S = 2, 6, 2, 300
    q = _x(B * nh * S, d, dtype, dev).reshape(B, nh, S, d)
    k = _x(B * nkv * S, d, dtype, dev).reshape(B, nkv, S, d)
    v = _x(B * nkv * S, d, dtype, dev).reshape(B, nkv, S, d)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       dtype=torch.float64)
        if dtype == torch.bfloat16:
            _within_one_ulp(got, want)
        else:
            _close(got, want, 1e-4)


def test_flash_attention_unaligned_base_raises(dev):
    """A contiguous view that starts off a 16-byte boundary (both bodies read
    16 bytes at a time; TMA takes no other base) is copied to a fresh buffer
    and computes, one launch, equal to the same values from an aligned
    base — it no longer raises."""
    for dtype, d in ((torch.bfloat16, 128), (torch.bfloat16, 32),
                     (torch.float32, 64), (torch.float32, 112)):
        flat = _x(2 * 100 * d + 1, 1, dtype, dev).reshape(-1)
        q = flat[1:].reshape(2, 100, d)
        assert q.data_ptr() % 16
        k = v = _x(2 * 100, d, dtype, dev).reshape(2, 100, d)
        for args, aligned in (((q, k, v), (q.clone(), k, v)),
                              ((k, q, v), (k, q.clone(), v)),
                              ((k, k, q), (k, k, q.clone()))):
            before = fa.launches
            got = fa.flash_attention(*args)
            torch.cuda.synchronize()
            assert fa.launches == before + 1
            assert torch.equal(got, fa.flash_attention(*aligned))


def test_flash_attention_offsets_past_2_31(dev):
    """16,448 heads × 1024 rows × 128: q has 2.16e9 elements, so the last
    heads sit past 2³¹ elements; they agree with the plain version."""
    bh, S, d = 16448, 1024, 128
    assert bh * S * d > 2 ** 31
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q, k, v = (torch.randn((bh, S, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    for h in (slice(0, 4), slice(bh - 4, bh)):
        want = ref.flash_attention_ref(q[h], k[h], v[h], causal=True,
                                       dtype=torch.float64)
        _close(out[h], want, 1e-2)
        _within_one_ulp(out[h], want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-0.5b"])
@pytest.mark.parametrize("serve_dtype,tol", [("float32", 1e-4),
                                             ("bfloat16", 2e-2)])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(dev, arch,
                                                         serve_dtype, tol):
    """A reduced model's prefill (one kernel launch a layer) and a decode
    step on the card against the same parameters on the CPU, where the
    attention is the kernel's plain version; float32 to 1e-4 of the largest
    logit, bf16 serving parameters and activations to 2e-2."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              dtype=serve_dtype)
    on = {d: steps.serving_model(cfg, serve_dtype=serve_dtype, device=d)
          for d in ("cpu", dev)}
    params = {"cpu": on["cpu"].init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 101)),
                           dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        before = fa.launches
        cache, logits = steps.build_prefill_step(on[d], 110)(
            params[d], {"tokens": toks[:, :100].to(d)})
        _, dec = steps.build_decode_step(on[d])(params[d], cache,
                                                toks[:, 100:].to(d))
        launched = fa.launches - before
        assert launched == (cfg.n_layers if d == dev else 0)
        out[d] = (logits, dec, cache["kv"]["k"])
    for a, b in zip(out[dev], out["cpu"]):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
