"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them: the same numpy inputs, the same tolerances
(f32 1e-4, bf16 2e-2, exact k-means labels).  The SpMM kernels, which the
reference file does not sweep, are held against the reference's Pallas
kernels in interpret mode too, and so is flash attention (the JAX tests'
S, causal and dtype sweep and tolerances 2e-3 / 3e-2, cross lengths, a
causal S != T case that pins the kernel's top-left mask, GQA against the
Pallas kernel on repeated KV, and the precision decision of the wgmma body:
P·V from P split into two bf16 terms holds one bf16 ulp of float64 where a
single rounding of P does not).  xty's launch plan is checked from the
shapes alone.  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrix as jmatrix
from repro.kernels import ops
from repro.kernels import ref as jref
from repro.kernels import spmm as jspmm
from repro_torch.core import fm, matrix
from repro_torch.kernels import (common, flash_attention as fa,
                                 fused_apply_agg as faa, gram as gram_mod,
                                 kmeans_assign as ka, ops as tops, ref, spmm,
                                 weighted_gram as wg)
from repro_torch.observability import metrics

RNG = np.random.default_rng(3)

ROWS = [8, 100, 1000]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    with fm.conf(device="cpu"):
        metrics.REGISTRY.reset()
        yield
        metrics.REGISTRY.reset()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(a, dtype):
    """The same values as a jax array and a torch CPU tensor."""
    a32 = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(
            torch.bfloat16)
    return jnp.asarray(a32), torch.from_numpy(a32.copy())


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [4, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    g = gram_mod.gram(xt)
    assert g.dtype == torch.float32 and g.shape == (p, p)
    np.testing.assert_allclose(g.numpy(), np.asarray(ops.gram(
        xj, block_rows=128)), **_tol(dtype))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [4, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgram_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    w = RNG.uniform(size=(n,)).astype(np.float32)
    g = wg.wgram(xt, torch.from_numpy(w).reshape(-1, 1))
    np.testing.assert_allclose(g.numpy(), np.asarray(ops.wgram(
        xj, jnp.asarray(w), block_rows=64)), **_tol(dtype))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p,q", [(8, 12), (12, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_xty_matches_pallas(n, p, q, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    yj, yt = _pair(RNG.normal(size=(n, q)), dtype)
    g = gram_mod.xty(xt, yt)
    assert g.dtype == torch.float32 and g.shape == (p, q)
    np.testing.assert_allclose(g.numpy(), np.asarray(ops.xty(
        xj, yj, block_rows=128)), **_tol(dtype))


def _ell_case(n, kmax, ncol):
    """An ELL slab with an all-padding row every 5th row, padding at the
    end of other rows and a duplicate column."""
    cols = RNG.integers(0, ncol, size=(n, kmax)).astype(np.int32)
    vals = RNG.uniform(0.5, 1.5, size=(n, kmax)).astype(np.float32)
    pad = RNG.uniform(size=(n, kmax)) < 0.25
    pad[::5] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if kmax > 1 and n > 1:
        cols[1, 1] = cols[1, 0]
    return cols, vals


@pytest.mark.parametrize("n,kmax,ncol", [(100, 1, 6), (257, 3, 23),
                                         (64, 5, 40)])
def test_spmm_matches_pallas(n, kmax, ncol):
    cols, vals = _ell_case(n, kmax, ncol)
    w = RNG.uniform(size=(n, 1)).astype(np.float32)
    y = RNG.normal(size=(n, 2)).astype(np.float32)
    ct, vt = torch.from_numpy(cols), torch.from_numpy(vals)
    cj, vj = jnp.asarray(cols), jnp.asarray(vals)
    for got, want in (
            (spmm.spmm_gram(ct, vt, ncol=ncol),
             jspmm.spmm_gram(cj, vj, ncol=ncol, interpret=True)),
            (spmm.spmm_xty(ct, vt, torch.from_numpy(y), ncol=ncol),
             jspmm.spmm_xty(cj, vj, jnp.asarray(y), ncol=ncol,
                            interpret=True)),
            (spmm.spmm_wgram(ct, vt, torch.from_numpy(w), ncol=ncol),
             jspmm.spmm_wgram(cj, vj, jnp.asarray(w), ncol=ncol,
                              interpret=True))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_spmm_plain_versions_work_in_row_chunks(monkeypatch):
    """The plain versions densify a chunk of rows at a time (a dense copy
    of the main path's slab would not fit): many small chunks give the
    one-chunk result."""
    cols, vals = _ell_case(300, 4, 17)
    ct, vt = torch.from_numpy(cols), torch.from_numpy(vals)
    y = torch.from_numpy(RNG.normal(size=(300, 3)).astype(np.float32))
    w = torch.rand(300)
    whole = (ref.spmm_gram_ref(ct, vt, 17), ref.spmm_xty_ref(ct, vt, y, 17),
             ref.spmm_wgram_ref(ct, vt, w, 17))
    monkeypatch.setattr(ref, "SPMM_CHUNK_ELEMS", 17 * 7)
    for a, b in zip(whole, (ref.spmm_gram_ref(ct, vt, 17),
                            ref.spmm_xty_ref(ct, vt, y, 17),
                            ref.spmm_wgram_ref(ct, vt, w, 17))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    dense = ref.spmm_dense_ref(ct, vt, 17, torch.float64).numpy()
    np.testing.assert_allclose(whole[0].numpy(), dense.T @ dense, rtol=1e-5)


@pytest.mark.parametrize("kmax,ncol,weighted,want", [
    (26, 1664, True, (240, 28)), (26, 1664, False, (240, 28)),
    (1, 5, False, (8, 1)), (40, 100, True, (104, 1))])
def test_spmm_tile_layout_fits_shared_memory(kmax, ncol, weighted, want):
    """The square tile the gram / wgram wrapper picks fills one block's 227
    KB alone (no staging: 240 and 28 upper-triangle tiles at Criteo), and
    the workspace of the splits' partial tiles stays under its cap; xty's
    warps' copies of its stripe fit beside nothing else, all ncol rows in
    one stripe at these shapes, whatever kmax (its rows are read from
    global memory, not staged)."""
    n = 45_840_617
    ts, tiles, splits = spmm.gram_layout(n, ncol)
    assert (ts, tiles) == want and ts == spmm.gram_tile(ncol)
    assert 4 * ts * ts <= spmm.SMEM_LIMIT and ts % 8 == 0 and ts >= min(
        ncol, 8)
    assert 4 * splits * tiles * ts * ts <= spmm.WS_CAP_BYTES
    cs, qc, warps = spmm.xty_tile(ncol, 1 + weighted)
    assert cs == ncol and qc == 1 + weighted
    assert spmm.XTY_MIN_WARPS <= warps <= spmm.XTY_MAX_WARPS
    assert 4 * warps * spmm.xty_copy_floats(cs * qc) <= spmm.SMEM_LIMIT


@pytest.mark.parametrize("ncol,q,want", [
    (1664, 1, (1664, 1, 32, 1)), (1664, 2, (1664, 2, 17, 1)),
    (1664, 40, (223, 32, 8, 16)), (5, 3, (5, 3, 32, 1)),
    (100_000, 1, (7152, 1, 8, 14)), (7152, 1, (7152, 1, 8, 1)),
    (7264, 1, (7152, 1, 8, 2))])
def test_spmm_xty_stripe_fits_shared_memory(ncol, q, want):
    """xty's layout, a function of (n, ncol, q) alone: every warp's skewed
    copy of the stripe inside 227 KB together, the stripes and Y's column
    tiles covering the output, one stripe of all ncol rows whenever 8
    copies of it fit (Criteo's 1,664 × 1: 32 warps), the workspace under its
    cap; the same at kmax 1 or 20,000, since no row is staged."""
    n = 45_840_617
    cs, qc, warps, tiles, splits = spmm.xty_layout(n, ncol, q)
    assert (cs, qc, warps, tiles) == want
    assert (cs, qc, warps) == spmm.xty_tile(ncol, q)
    assert spmm.XTY_MIN_WARPS <= warps <= spmm.XTY_MAX_WARPS
    copy = spmm.xty_copy_floats(cs * qc)
    assert copy - 1 == (cs * qc - 1) + (cs * qc - 1) // 64  # skew(last) + 1
    assert 4 * warps * copy <= spmm.SMEM_LIMIT
    assert cs == ncol or 4 * spmm.XTY_MIN_WARPS * spmm.xty_copy_floats(
        ncol * qc) > spmm.SMEM_LIMIT
    assert tiles == -(-ncol // cs) * -(-q // qc) and qc == min(q, 32)
    assert 4 * splits * tiles * cs * qc <= spmm.WS_CAP_BYTES
    assert splits == spmm.xty_layout(n, ncol, q)[4] >= 1


@pytest.mark.parametrize("d", [80, 96, 112, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_wide_head_dims_match_pallas(d, causal, dtype):
    """The head dims of the hybrid (112) and VLM (256) families and the
    other multiples of 16 the card takes: the plain path computes them as
    the Pallas kernel does, at its tolerances."""
    (qj, qt), (kj, kt), (vj, vt) = _attn((2, 70, d), (2, 70, d), dtype)
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = ops.flash_attention(qj, kj, vj, causal=causal, bq=32, bk=48,
                               interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_attn_tol(dtype))
    assert d in fa.HEAD_DIMS


def test_spmm_xty_declines_rows_too_wide_for_its_tile():
    """A sparse source of kmax = 20,000 (8 rows), which spmm_xty's old
    staged body had no room for and the matcher declined: since the warp-
    per-row body (no staging, any kmax) nothing is declined for its width,
    so spmm_xty claims the XᵀY segment, as spmm_gram claims XᵀX, no
    decline names kmax, and the result equals the JAX package's (its
    Pallas kernel in interpret mode and the engine) and numpy's."""
    from repro.core import fm as jfm
    from repro.core.matrix import FMMatrix as JFMMatrix
    from repro.storage.sparse import SparseEllStore as JStore
    from repro_torch.core import lowering
    from repro_torch.core.fusion import Plan
    from repro_torch.core.matrix import FMMatrix
    from repro_torch.storage import SparseEllStore
    n, kmax, ncol = 8, 20_000, 64
    cols, vals = _ell_case(n, kmax, ncol)
    y = RNG.normal(size=(n, 2)).astype(np.float32)
    ct, vt = torch.from_numpy(cols), torch.from_numpy(vals)
    X = fm.FM(FMMatrix((n, ncol), torch.float32,
                       store=SparseEllStore(ct, vt, ncol)))
    xty = fm.crossprod(X, fm.conv_R2FM(y))
    plan = Plan([xty.m, fm.crossprod(X).m])
    text = " | ".join(lowering.dispatch_report(plan, plan.ir,
                                               "cuda").values())
    assert "cuda:spmm_xty (claimed by match_spmm)" in text
    assert "cuda:spmm_gram (claimed by match_spmm)" in text
    assert "kmax" not in text and "declined" not in text
    (got,) = fm.materialize(xty, backend="cuda")
    J = jfm.FM(JFMMatrix((n, ncol), np.float32,
                         store=JStore(cols, vals, ncol)))
    (want,) = jfm.materialize(jfm.crossprod(J, jfm.conv_R2FM(y)),
                              backend="xla")
    pallas = jspmm.spmm_xty(jnp.asarray(cols), jnp.asarray(vals),
                            jnp.asarray(y), ncol=ncol, interpret=True)
    dense = np.zeros((n, ncol))
    np.add.at(dense, (np.repeat(np.arange(n), kmax), cols.reshape(-1)),
              vals.reshape(-1))
    np.testing.assert_allclose(fm.as_np(got), jfm.as_np(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(fm.as_np(got), np.asarray(pallas), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(fm.as_np(got), dense.T @ y, rtol=1e-4,
                               atol=1e-3)
    assert spmm.xty_tile(ncol, 2) == (ncol, 2, spmm.XTY_MAX_WARPS)


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [1, 7, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_summary_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    outs = faa.fused_summary(xt)
    refs = ops.fused_summary(xj, block_rows=64)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(_np(o).astype(np.float32),
                                   np.asarray(r, np.float32), **_tol(dtype))


_CHAIN_CASES = {
    # int32 source, exact int32 accumulators
    "int_acc": (np.int32, (((), "sum", "int32"), (("sq",), "sum", "int32"),
                           (("abs", "neg"), "min", "int32"),
                           ((), "max", "int32"), ((), "count", "int32"),
                           ((), "count_nonzero", "int32"))),
    # lazy casts inside the chain, int and float accumulators
    "casts": (np.int32, ((("cast_float32", "sqrt"), "sum", "float32"),
                         (("cast_float32", "sq"), "max", "float32"),
                         (("cast_bfloat16", "sq"), "sum", "float32"),
                         (("abs", "sqrt", "cast_int32"), "sum", "int32"))),
    # every float unary once
    "unaries": (np.float32, tuple(((u,), "sum") for u in (
        "identity", "abs", "sq", "exp", "neg", "sigmoid", "floor", "ceil",
        "round", "sign", "cast_float32", "cast_bfloat16"))),
    "domain": (np.float32, ((("abs", "sqrt"), "sum"), (("abs", "log1p"),
                                                       "max"),
                            (("abs", "exp", "log"), "min"))),
}


@pytest.mark.parametrize("case", sorted(_CHAIN_CASES))
@pytest.mark.parametrize("n", [37, 1000])
def test_fused_apply_agg_chains_match_pallas(case, n):
    dt, chains = _CHAIN_CASES[case]
    a = (RNG.normal(size=(n, 5)) * 20).astype(dt)
    outs = faa.fused_apply_agg(torch.from_numpy(a.copy()), chains)
    refs = ops.fused_apply_agg(jnp.asarray(a), chains, block_rows=64)
    for chain, o, r in zip(faa.normalize_chains(chains), outs, refs):
        assert str(o.dtype).endswith(chain[2])
        if chain[2] == "int32":
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("src", ["nan", "all_negative"])
def test_fused_apply_agg_min_max_edges_match_pallas(src):
    a = -RNG.uniform(1.0, 2.0, size=(300, 4)).astype(np.float32)
    if src == "nan":
        a[7, 2] = np.nan
    chains = (((), "min"), ((), "max"), (("abs",), "max"), ((), "sum"))
    outs = faa.fused_apply_agg(torch.from_numpy(a.copy()), chains)
    refs = ops.fused_apply_agg(jnp.asarray(a), chains, block_rows=64)
    for (_, agg), o, r in zip(chains, outs, refs):
        if agg == "sum":
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", ROWS + [513])
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kmeans_assign_matches_pallas(n, k, dtype):
    xj, xt = _pair(RNG.normal(size=(n, 8)), dtype)
    cj, ct = _pair(RNG.normal(size=(k, 8)), dtype)
    lab, sums, cnts, wss = ka.kmeans_assign(xt, ct)
    rl, rs, rc, rw = ops.kmeans_assign(xj, cj, block_rows=64)
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(rl))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), **_tol(dtype))
    np.testing.assert_allclose(cnts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(wss.numpy(), np.asarray(rw),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-3)


@pytest.mark.parametrize("n,p,dtype,live", [(10, 4, np.float32, 2),
                                            (100000, 12, np.float32, 3),
                                            (5000, 7, np.int32, 2),
                                            (3, 1, np.float32, 2)])
def test_block_rows_and_padding_match_reference(n, p, dtype, live):
    """The plan IR's partition rows (``block_rows``) follow the reference's
    power-of-two rule, so plans, signatures and counters match.  The port
    keeps one copy of the rule; its kernels mask a ragged edge instead of
    padding X, which the ``*_matches_pallas`` tests cover at n = 100, 1000."""
    tdt = torch.float32 if dtype == np.float32 else torch.int32
    for budget in (None, 64 * p, 1 << 20):
        assert matrix.proc_partition_rows(p, tdt, live, budget) == \
            jmatrix.proc_partition_rows(p, dtype, live, budget)
        assert matrix.io_partition_rows(p, tdt, live, budget) == \
            jmatrix.io_partition_rows(p, dtype, live, budget)
    assert matrix.proc_partition_rows(p, tdt, live) <= \
        matrix.io_partition_rows(p, tdt, live)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted, and a CUDA tensor is the only way to the kernel."""
    counters = ((gram_mod, "launches"), (gram_mod, "tri_launches"),
                (gram_mod, "xty_launches"), (wg, "launches"), (wg, "tri_launches"), (faa, "launches"),
                (faa, "ring_launches"), (ka, "launches"), (ka, "tma_launches"),
                (spmm, "gram_launches"), (spmm, "xty_launches"),
                (spmm, "wgram_launches"), (fa, "launches"))
    before = [getattr(m, a) for m, a in counters]
    x = torch.randn(64, 4)
    cols, vals = torch.zeros(64, 2, dtype=torch.int32), torch.ones(64, 2)
    gram_mod.gram(x)
    gram_mod.xty(x, x[:, :1])
    wg.wgram(x, torch.rand(64))
    faa.fused_summary(x)
    ka.kmeans_assign(x, x[:3])
    spmm.spmm_gram(cols, vals, ncol=3)
    spmm.spmm_xty(cols, vals, x, ncol=3)
    spmm.spmm_wgram(cols, vals, torch.rand(64), ncol=3)
    fa.flash_attention(x.reshape(1, 16, 16), x.reshape(1, 16, 16),
                       x.reshape(1, 16, 16))
    tops.attention(x.reshape(1, 16, 16), x.reshape(1, 16, 16),
                   x.reshape(1, 16, 16))
    assert [getattr(m, a) for m, a in counters] == before


def test_wrappers_validate_inputs():
    with pytest.raises(TypeError):
        gram_mod.gram(torch.zeros(8, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        wg.wgram(torch.zeros(8, 2), torch.zeros(7))
    with pytest.raises(ValueError):
        faa.fused_apply_agg(torch.zeros(8, 2), (((), "median"),))
    with pytest.raises(ValueError):
        faa.fused_apply_agg(torch.zeros(8, 2), ((("tanh",), "sum"),))
    with pytest.raises(ValueError):
        ka.kmeans_assign(torch.zeros(8, 2), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        common.route(torch.zeros(2), torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        gram_mod.xty(torch.zeros(8, 2), torch.zeros(7, 1))
    with pytest.raises(TypeError):
        gram_mod.xty(torch.zeros(8, 2), torch.zeros(8, 1, dtype=torch.bfloat16))
    cols = torch.zeros(8, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        spmm.spmm_gram(cols.long(), torch.ones(8, 2), ncol=3)
    with pytest.raises(ValueError):
        spmm.spmm_gram(cols, torch.ones(8, 3), ncol=3)
    with pytest.raises(ValueError):
        spmm.spmm_wgram(cols, torch.ones(8, 2), torch.ones(7), ncol=3)
    with pytest.raises(ValueError):
        spmm.spmm_xty(cols, torch.ones(8, 2), torch.ones(7, 1), ncol=3)
    q = torch.zeros(2, 4, 8, 16)
    for bad in ((q, q[:, :3], q[:, :3]),                     # 4 % 3 heads
                (q, q[..., :8], q[..., :8]),                 # q 16, k 8
                (q, q[:, :2, :0], q[:, :2, :0]),             # no keys
                (q, q[:1, :2], q[:1, :2])):                  # batch
        with pytest.raises(ValueError):
            fa.flash_attention(*bad)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(TypeError):
        fa.flash_attention(*(q.half(),) * 3)
    with pytest.raises(ValueError):
        tops.attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("n,p,q", [(65_608_366, 8, 32), (65_608_366, 32, 1),
                                   (5, 3, 40), (70_001, 40, 16),
                                   (1_000_000, 16, 17)])
def test_xty_plan_and_thin_geometry(n, p, q):
    """xty's splits and workspace are functions of (n, p, q) alone, equal
    on every call; the thin path's narrow width maps to a built width, the
    smallest at or above it; and the workspace covers every block's partial
    (Friendster-32's NMF and GMM shapes among them): computed from the
    shapes, nothing allocated."""
    splits, ws = gram_mod.xty_plan(n, p, q)
    assert (splits, ws) == gram_mod.xty_plan(n, p, q)
    assert 1 <= splits <= 65535 and -(-n // splits) * splits >= n
    na, nw = min(p, q), max(p, q)
    assert na <= gram_mod.THIN
    width = gram_mod.thin_width(na)
    assert width in gram_mod.THIN_WIDTHS and width >= na
    assert all(w < na for w in gram_mod.THIN_WIDTHS if w < width)
    tiles = -(-nw // gram_mod.TILE)
    # the last block's partial: (split · tiles + tile) · THIN · 32 + na · 32
    last = ((splits - 1) * tiles + tiles - 1) * gram_mod.THIN * 32 + na * 32
    assert last <= ws == splits * tiles * gram_mod.THIN * 32
    if n > 10 ** 6:  # the blocks a launch gives an SM, capped by rows
        assert splits == min(gram_mod.THIN_BLOCKS[width] * common.SM_COUNT
                             // tiles, -(-n // 1024))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("p", [1, 7, 12, 31, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgram_plan_geometry(p, dtype, weighted):
    """wgram's plan (``weighted``) and gram's from the shape alone: p ≤ 32
    takes the triangle body, whose chunks (rows, and their weights for
    wgram) are whole multiples of 16 bytes at every p and dtype (what
    cp.async.bulk moves), whose ring and tile partials fit beside two
    blocks an SM, whose chunk is a whole number of the rows a block takes a
    step, and whose splits cover n in whole chunks, at most two blocks an
    SM; p > 32 stays on the tile body.  Equal on every call, nothing
    allocated."""
    elem = 2 if dtype == torch.bfloat16 else 4
    row_bytes = p * elem + 4 * weighted
    for n in (1, 3, 1000, 70_001, 65_608_366):
        plan = gram_mod.tri_plan(n, p, dtype, weighted)
        assert plan == gram_mod.tri_plan(n, p, dtype, weighted)
        assert 1 <= plan.splits <= 65535
        assert plan.splits * plan.rows_per_split >= n
        assert (plan.splits - 1) * plan.rows_per_split < n
        if p > gram_mod.TRI_MAX_P:
            assert plan.body == "tile"
            assert plan.splits == gram_mod.gram_splits(n, p)
            assert plan.ws_floats == plan.splits * 4 * gram_mod.TILE ** 2
            continue
        R = plan.chunk_rows
        nb = -(-p // 8)
        step = gram_mod.TRI_THREADS // 32 * (32 // (nb * (nb + 1) // 2))
        assert plan.body == "tri" and R % 8 == 0 and R % step == 0
        assert (R * p * elem) % 16 == 0 and (R * row_bytes) % 16 == 0
        assert plan.rows_per_split % R == 0
        assert R * row_bytes <= gram_mod.TRI_STAGE_BYTES
        assert plan.smem_bytes == gram_mod.TRI_BARS + max(
            plan.stages * R * row_bytes,
            gram_mod.TRI_THREADS // 32 * nb * (nb + 1) // 2 * 256)
        assert 8 * plan.stages <= gram_mod.TRI_BARS
        assert gram_mod.TRI_BLOCKS_PER_SM * (plan.smem_bytes + 1024) \
            <= 228 * 1024
        assert plan.splits <= gram_mod.TRI_BLOCKS_PER_SM * common.SM_COUNT
        assert plan.ws_floats == plan.splits * p * p
    if (p, dtype, weighted) == (32, torch.float32, False):
        # gram at the main path's width: 240 rows (30 KB) a stage, 3 stages
        assert (R, plan.stages, plan.smem_bytes) == (240, 3, 92_224)


@pytest.mark.parametrize("p", [1, 5, 12, 32, 33, 100, 256, 257])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_chain_plan_geometry(p, dtype):
    """fused_apply_agg's plan from the shape alone: p ≤ 256 takes the ring
    body, whose chunks are whole multiples of 16 bytes (what cp.async.bulk
    moves) and of lanes × RING_V rows (so a full chunk needs no row mask),
    whose lanes of p threads fit the block, whose stages (and the lanes'
    partials) fit beside two blocks an SM, and whose splits cover n in
    whole chunks, at most two blocks an SM; p > 256 stays on the tile body.
    Equal on every call, nothing allocated."""
    elem = 2 if dtype == torch.bfloat16 else 4
    for n in (0, 1, 7, 1000, 70_001, 65_608_366):
        plan = faa.chain_plan(n, p, dtype)
        assert plan == faa.chain_plan(n, p, dtype)
        assert 1 <= plan.splits <= 65535
        assert plan.splits * plan.rows_per_split >= n
        assert n == 0 or (plan.splits - 1) * plan.rows_per_split < n
        if p > faa.RING_MAX_P:
            assert plan.body == "tile" and plan.chunk_rows == 0
            assert plan.splits == common.splits_for(n, 512, -(-p // 32))
            continue
        R, L = plan.chunk_rows, plan.lanes
        assert plan.body == "ring" and L == faa.RING_THREADS // p >= 1
        assert L * p <= faa.RING_THREADS
        assert (R * p * elem) % 16 == 0 and R % (L * faa.RING_V) == 0
        assert plan.rows_per_split % R == 0
        assert R * p * elem <= faa.RING_STAGE_BYTES
        assert plan.smem_bytes == faa.RING_BARS + max(
            plan.stages * R * p * elem, L * faa.MAX_CHAINS * p * 4)
        assert 8 * plan.stages <= faa.RING_BARS
        assert faa.RING_BLOCKS_PER_SM * (plan.smem_bytes + 1024) \
            <= 228 * 1024
        assert plan.splits <= faa.RING_BLOCKS_PER_SM * common.SM_COUNT


@pytest.mark.parametrize("p,k,dtype,body", [
    (4, 1, torch.float32, "tma"), (8, 2, torch.float32, "tma"),
    (16, 64, torch.float32, "tma"), (32, 10, torch.float32, "tma"),
    (32, 500, torch.float32, "tma"), (24, 10, torch.float32, "tma"),
    (32, 1000, torch.float32, "tma"),
    (8, 10, torch.bfloat16, "tma"), (32, 500, torch.bfloat16, "tma"),
    (3, 10, torch.float32, "staged"), (300, 3, torch.float32, "staged"),
    (32, 60_000, torch.float32, "staged"), (4, 10, torch.bfloat16, "staged"),
    (33, 10, torch.float32, "staged"), (1, 60_000, torch.float32, "staged")])
def test_lloyd_plan_geometry(p, k, dtype, body):
    """kmeans_assign's plan from the shape alone: p ≤ 32 in rows of 16 to
    128 bytes takes the TMA body when the centers fit, with boxes of at most
    256 rows (TMA's limit) and the ring (every row at the swizzle's 128-byte
    pitch), centers, ‖c‖² and any shared partials inside one block's 227
    KB (two blocks an SM only when two fit), the partials in shared lanes of
    p / 4 threads or, when no lane fits, in the workspace; every other shape
    takes the staged body.  The workspace holds every block's sums, counts
    and wss."""
    for n in (1, 255, 256, 257, 70_001, 65_608_366):
        plan = ka.lloyd_plan(n, p, k, dtype)
        assert plan == ka.lloyd_plan(n, p, k, dtype)
        assert plan.body == body
        assert 1 <= plan.blocks <= min(-(-n // 256), 4 * common.SM_COUNT)
        assert plan.box_rows <= 256 and plan.box_rows == ka.TMA_THREADS
        if body == "staged":
            assert plan.ws_floats == plan.blocks * (k * p + k + 1) + k
            continue
        assert plan.stages in ka.TMA_STAGES
        assert plan.smem_bytes == ka.tma_smem(p, k, plan.stages, plan.lanes,
                                              plan.part_smem)
        assert plan.smem_bytes >= plan.stages * 256 * ka.TMA_PITCH \
            + -(-k // ka.TMA_KB) * ka.TMA_KB * (p + 1) * 4
        assert plan.smem_bytes <= ka.SMEM_LIMIT
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= ka.SM_SMEM
        assert plan.blocks <= plan.blocks_per_sm * common.SM_COUNT
        assert 1 <= plan.lanes
        assert plan.lanes * (p // ka.TMA_GATHER_COLS) <= ka.TMA_THREADS
        assert plan.part_smem or plan.lanes == 1
        assert plan.ws_floats == plan.blocks * (k * p + k + 1)
    if (p, k, dtype) == (32, 10, torch.float32):   # the main path
        plan = ka.lloyd_plan(65_608_366, p, k, dtype)
        assert (plan.stages, plan.blocks_per_sm, plan.lanes,
                plan.part_smem) == (2, 2, 32, True)


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """A library is keyed by its source, every shared csrc/*.cuh header and
    the flags: an edit to the header gives every source a new digest (so no
    stale kernel is loaded), and an edit to one source only that one."""
    from repro_torch.kernels import build
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    monkeypatch.setattr(build, "CSRC", src)
    assert list(src.glob("*.cuh"))
    before = {name: build._digest(name) for name in build.SOURCES}
    header = src / "hopper_async.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._digest(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)
    cu = src / "gram.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    again = {name: build._digest(name) for name in build.SOURCES}
    assert [name for name in build.SOURCES if again[name] != after[name]] \
        == ["gram"]


def test_xty_thin_widths_cover_every_narrow_width():
    assert [gram_mod.thin_width(na) for na in range(1, 17)] == \
        [1, 2, 4, 4] + [8] * 4 + [16] * 8
    for bad in (0, 17):
        with pytest.raises(ValueError):
            gram_mod.thin_width(bad)


def test_chain_program_encodes_type_changes():
    """The int program the kernel reads: opcodes and the value type entering
    each step (0 int, 1 f32, 2 bf16) follow the reference chain's casts;
    the source type the kernel reads uses the same codes."""
    prog = faa.encode(((("sq", "sqrt", "cast_int32", "cast_bfloat16"),
                        "max", "int32"),), torch.int32)
    assert prog[:2] == [1, 0]
    assert faa.encode(((("sq",), "sum", "int32"),),
                      torch.bfloat16)[:4] == [1, 2, 1, 2]
    assert faa.encode(((("sq",), "sum", "float32"),),
                      torch.float32)[:4] == [1, 1, 1, 1]
    nsteps, start, agg, acc_int = prog[2:6]
    ops_ = prog[6:6 + 16][:nsteps]
    types = prog[6 + 16:6 + 32][:nsteps]
    assert (nsteps, start, agg, acc_int) == (4, 0, 2, 1)
    assert [faa.CHAIN_UNARIES[o] for o in ops_] == [
        "sq", "sqrt", "cast_int32", "cast_bfloat16"]
    assert types == [0, 0, 1, 0]


def _attn(shape_q, shape_kv, dtype):
    q = RNG.normal(size=shape_q)
    k, v = RNG.normal(size=shape_kv), RNG.normal(size=shape_kv)
    return [_pair(a, dtype) for a in (q, k, v)]


def _attn_tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s", [32, 100, 160])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_pallas(s, causal, dtype):
    """tests/test_kernels.py's sweep: (2, S, 16), Pallas blocks 32 × 48."""
    (qj, qt), (kj, kt), (vj, vt) = _attn((2, s, 16), (2, s, 16), dtype)
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = ops.flash_attention(qj, kj, vj, causal=causal, bq=32, bk=48,
                               interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_attn_tol(dtype))


@pytest.mark.parametrize("sq,sk,causal", [(40, 100, False), (100, 40, False),
                                          (40, 100, True), (100, 40, True)])
def test_flash_attention_cross_lengths_match_pallas(sq, sk, causal):
    """Cross lengths; causal with S != T pins the top-left mask by absolute
    ids (q_id >= k_id), where the reference's attention_ref, bottom-right,
    differs."""
    (qj, qt), (kj, kt), (vj, vt) = _attn((1, sq, 16), (1, sk, 16), "float32")
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    want = np.asarray(ops.flash_attention(qj, kj, vj, causal=causal, bq=16,
                                          bk=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    if causal and sq < sk:
        bottom_right = np.asarray(jref.attention_ref(qj, kj, vj, causal=True))
        assert np.abs(bottom_right - want).max() > 0.5


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_matches_pallas_on_repeated_kv(g, causal):
    """(B, nh, S, D) over (B, nkv, T, D) with nh = g·nkv, KV read per group
    (never repeated), against the Pallas kernel on KV repeated g times."""
    B, nkv, S, d = 2, 2, 50, 32
    q = RNG.normal(size=(B, nkv * g, S, d)).astype(np.float32)
    k = RNG.normal(size=(B, nkv, S, d)).astype(np.float32)
    v = RNG.normal(size=(B, nkv, S, d)).astype(np.float32)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    rep = [np.repeat(a, g, axis=1).reshape(B * nkv * g, S, d) for a in (k, v)]
    want = ops.flash_attention(jnp.asarray(q.reshape(-1, S, d)),
                               *(jnp.asarray(a) for a in rep), causal=causal,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(q.shape),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("scale", [0.0, -0.3])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_zero_and_negative_scale_match_pallas(scale, causal):
    """The Pallas kernel masks after the scale, so a zero scale averages the
    unmasked keys and a negative one still drops the masked ones; the port
    (here its plain version, on the card both bodies) does the same.  The
    Pallas kernel is called unjitted: its jit takes no explicit scale."""
    (qj, qt), (kj, kt), (vj, vt) = _attn((2, 70, 16), (2, 70, 16), "float32")
    got = fa.flash_attention(qt, kt, vt, causal=causal, scale=scale)
    want = ops.flash_attention.__wrapped__(qj, kj, vj, causal=causal,
                                           scale=scale, bq=32, bk=48,
                                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def _split_p_attention(q, k, v, terms):
    """The wgmma body's arithmetic in plain PyTorch, causal over S = T, GQA:
    scores and P = exp(s - max) in f32, P·V from bf16 terms of P (hi, or
    hi + lo with lo = bf16(P - hi)) times bf16 V, products exact and sums
    in f32, divided by the f32 row sum, rounded once to bf16."""
    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, 1).float() for t in (k, v))
    S = q.shape[2]
    s = (q.float() @ kr.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(torch.arange(S)[:, None] < torch.arange(S)[None, :],
                      ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    o = hi @ vr
    if terms == 2:
        o = o + (p - hi).bfloat16().float() @ vr
    return (o / p.sum(-1, keepdim=True)).bfloat16()


def _ulp_excess(o, o64):
    """max(|o - o64| - (1e-5 + 2⁻⁷·|o64|)): above 0 is more than one bf16
    ulp off float64."""
    return float(((o.double() - o64).abs() - 1e-5 - 2.0 ** -7 * o64.abs())
                 .max())


@pytest.mark.parametrize("S,d,g", [(70, 64, 3), (128, 128, 3), (257, 64, 1)])
def test_flash_attention_split_p_holds_one_bf16_ulp(S, d, g):
    """Why the wgmma body splits P: on bf16 q/k/v from N(0, 1), causal,
    P·V from P_hi + P_lo stays within one bf16 ulp of the float64 function
    (chip_smoke.py's limit), while a single bf16 rounding of P, as
    FlashAttention and SDPA do, misses it on the early rows, which average
    a few keys.  The split emulation, rounded once, also agrees with the
    Pallas kernel (interpret mode, f32 P) within one bf16 ulp: each
    rounds once."""
    B, nkv = 1, 2
    (qj, q), (kj, k), (vj, v) = _attn((B, nkv * g, S, d), (B, nkv, S, d),
                                      "bfloat16")
    o64 = ref.flash_attention_ref(q, k, v, causal=True, dtype=torch.float64)
    split = _split_p_attention(q, k, v, terms=2)
    assert _ulp_excess(split, o64) <= 0
    assert _ulp_excess(_split_p_attention(q, k, v, terms=1), o64) > 1e-4
    rep = [jnp.repeat(a, g, axis=1).reshape(-1, S, d) for a in (kj, vj)]
    pallas = ops.flash_attention(qj.reshape(-1, S, d), *rep, causal=True,
                                 bq=64, bk=64, interpret=True)
    pallas = torch.from_numpy(np.asarray(pallas, np.float32)).reshape(
        split.shape).double()
    assert _ulp_excess(split, pallas) <= 0


@pytest.mark.parametrize("sq,sk", [(32, 32), (40, 100), (100, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_ref(sq, sk, causal):
    """The twin of repro/kernels/ref.py:attention_ref (bottom-right causal
    mask, -inf), NaN rows included where S > T and causal."""
    (qj, qt), (kj, kt), (vj, vt) = _attn((2, sq, 16), (2, sk, 16), "float32")
    got = ref.attention_ref(qt, kt, vt, causal=causal).numpy()
    want = np.asarray(jref.attention_ref(qj, kj, vj, causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_plain_versions_work_in_chunks(monkeypatch):
    """The plain versions form the scores a chunk of heads and rows at a
    time (one serving layer whole would be 6.4 GB): small chunks give the
    one-chunk result, and ops.attention's impls agree on the CPU."""
    (_, q), (_, k), (_, v) = _attn((2, 6, 70, 32), (2, 2, 70, 32), "float32")
    whole = [f(q, k, v, causal=True) for f in (ref.flash_attention_ref,
                                               ref.attention_ref)]
    assert torch.equal(tops.attention(q, k, v, impl="ref"), whole[0])
    assert torch.equal(tops.attention(q, k, v), whole[0])
    monkeypatch.setattr(ref, "ATTN_CHUNK_ELEMS", 70 * 9)
    for w, f in zip(whole, (ref.flash_attention_ref, ref.attention_ref)):
        np.testing.assert_allclose(f(q, k, v, causal=True).numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6)
