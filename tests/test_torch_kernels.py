"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them: the same numpy inputs, the same tolerances
(f32 1e-4, bf16 2e-2, exact k-means labels).  The SpMM kernels, which the
reference file does not sweep, are held against the reference's Pallas
kernels in interpret mode too.  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrix as jmatrix
from repro.kernels import ops
from repro.kernels import spmm as jspmm
from repro_torch.core import fm, matrix
from repro_torch.kernels import (common, fused_apply_agg as faa,
                                 gram as gram_mod, kmeans_assign as ka,
                                 spmm, weighted_gram as wg)
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
    from repro_torch.kernels import ref
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
    (26, 1664, True, (208, 2)), (26, 1664, False, (208, 2)),
    (1, 5, False, (8, 1)), (40, 100, True, (104, 4))])
def test_spmm_tile_layout_fits_shared_memory(kmax, ncol, weighted, want):
    """The square tile and threads a row the wrapper picks: the staging
    buffers and the tile fit one block's 227 KB, as csrc/spmm.cu computes."""
    ts, tpr = spmm.gram_tile(ncol, kmax, weighted)
    assert (ts, tpr) == want
    kp = kmax | 1
    smem = 4 * (ts * ts + 2 * (spmm.THREADS // tpr) * (2 * kp + weighted))
    assert smem <= spmm.SMEM_LIMIT
    cs, qc, tpr = spmm.xty_tile(ncol, 1, kmax)
    assert cs == ncol and qc == 1
    n = 45_840_617
    nst = -(-ncol // ts)
    tiles = nst * (nst + 1) // 2
    splits = spmm.spmm_splits(n, tiles, ts * ts)
    assert 4 * splits * tiles * ts * ts <= spmm.WS_CAP_BYTES


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
    counters = ((gram_mod, "launches"), (gram_mod, "xty_launches"),
                (wg, "launches"), (faa, "launches"), (ka, "launches"),
                (spmm, "gram_launches"), (spmm, "xty_launches"),
                (spmm, "wgram_launches"))
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
