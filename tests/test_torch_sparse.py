"""The sparse (one-hot) tier of the port in ``whole`` mode on the device
tier, the twins of tests/test_sparse.py: ELL/CSR conversions, factor and
one-hot construction, engine parity with the dense oracle and with the JAX
package under both backends (``cuda``'s SpMM wrappers run their plain
versions on the CPU), sparse GLM against the dense fit, and the plan-cache
signature.  The disk-tier halves of the reference file (CSR ``.fmat``,
ingest, ``ooc``/``stream`` modes, meshes) come with ROADMAP A7 and A13."""
import numpy as np
import pytest
import torch

from repro.core import fm as jfm
from repro_torch.core import fm
from repro_torch.core import lowering
from repro_torch.core.fusion import Plan
from repro_torch.core.sparse import (SparseBlock, csr_from_dense,
                                     csr_from_ell, ell_from_csr_rows)
from repro_torch.kernels import spmm
from repro_torch.observability import metrics

BACKENDS = ["torch", "cuda"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    with fm.conf(device="cpu"):
        metrics.REGISTRY.reset()
        yield
        metrics.REGISTRY.reset()


def _codes(seed, n, levels):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, lv, n) for lv in levels]


def _one_hot_case(seed=0, n=600, levels=(7, 5, 11), pkg=fm):
    codes = _codes(seed, n, levels)
    X = pkg.one_hot(*[pkg.as_factor(c, lv) for c, lv in zip(codes, levels)],
                    host=False)
    dense = np.zeros((n, sum(levels)), np.float32)
    off = np.cumsum([0] + list(levels[:-1]))
    for c, o in zip(codes, off):
        dense[np.arange(n), c + o] = 1.0
    return X, dense


def test_ell_csr_conversions():
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(31, 9)).astype(np.float32)
    dense *= rng.random(dense.shape) < 0.4
    dense[4] = 0.0                                   # an all-padding row
    indptr, indices, data = csr_from_dense(dense)
    kmax = max(1, int(np.diff(indptr).max()))
    blk = ell_from_csr_rows(indptr, indices, data, 0, 31, kmax, 9)
    np.testing.assert_array_equal(blk.todense(), dense)
    ip2, ix2, d2 = csr_from_ell(blk.cols, blk.vals)
    np.testing.assert_array_equal(ip2, indptr)
    np.testing.assert_array_equal(ix2, indices)
    np.testing.assert_array_equal(d2, data)
    tblk = SparseBlock(torch.from_numpy(blk.cols), torch.from_numpy(blk.vals),
                       9)
    np.testing.assert_array_equal(tblk.todense().numpy(), dense)
    assert tblk.shape == (31, 9) and tblk.kmax == kmax
    B = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tblk.matmul_small(torch.from_numpy(B), chunk_elems=20).numpy(),
        dense @ B, rtol=1e-5, atol=1e-6)


def test_sparse_nbytes_is_nnz_proportional():
    X, dense = _one_hot_case(n=400, levels=(1000, 1000))
    assert X.m.is_sparse and X.m.nbytes() < dense.nbytes / 50
    moved = fm.persist(X, tier="device")
    assert moved.m.is_sparse and moved.m.nbytes() == X.m.nbytes()
    np.testing.assert_array_equal(fm.as_np(moved), dense)


def test_as_factor_validation():
    f = fm.as_factor(np.array([0, 2, 1, 2]))
    assert f.num_levels == 3 and len(f) == 4
    with pytest.raises(ValueError, match="negative"):
        fm.as_factor(np.array([0, -1]))
    with pytest.raises(ValueError, match="out of range"):
        fm.as_factor(np.array([0, 5]), num_levels=3)
    with pytest.raises(ValueError, match="integer"):
        fm.as_factor(np.array([0.5, 1.0]))
    g = fm.as_factor(fm.conv_R2FM(np.array([1.0, 0.0, 3.0])), num_levels=5)
    assert g.num_levels == 5 and g.codes.tolist() == [1, 0, 3]


def test_one_hot_matches_dense_oracle():
    X, dense = _one_hot_case()
    assert X.m.is_sparse and X.shape == dense.shape
    np.testing.assert_array_equal(fm.as_np(X), dense)
    J, _ = _one_hot_case(pkg=jfm)
    np.testing.assert_array_equal(fm.as_np(X), jfm.as_np(J))
    with pytest.raises(ValueError, match="lengths differ"):
        fm.one_hot(fm.as_factor(np.arange(4)), fm.as_factor(np.arange(5)),
                   host=False)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_crossprod_parity(backend):
    X, dense = _one_hot_case(seed=3)
    (G,) = fm.materialize(fm.crossprod(X), backend=backend)
    np.testing.assert_allclose(
        fm.as_np(G), dense.T.astype(np.float64) @ dense, rtol=1e-4)
    J, _ = _one_hot_case(seed=3, pkg=jfm)
    (JG,) = jfm.materialize(jfm.crossprod(J),
                            backend="pallas" if backend == "cuda" else "xla")
    np.testing.assert_allclose(fm.as_np(G), jfm.as_np(JG), rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_rowlocal_and_sinks_parity(backend):
    """Row-local chains and sinks densify the ELL block locally; X @ B keeps
    the gather path; the shared values keep the SparseBlock."""
    X, dense = _one_hot_case(seed=4)
    Z = (X * 3.0 - 1.0)
    B = np.full((23, 2), 0.5, np.float32)
    zm, s, m, g = fm.materialize(Z, fm.colSums(X), X @ B, fm.crossprod(X),
                                 backend=backend)
    np.testing.assert_allclose(fm.as_np(zm), dense * 3.0 - 1.0, rtol=1e-5)
    np.testing.assert_allclose(fm.as_np(s).reshape(-1), dense.sum(0),
                               rtol=1e-5)
    np.testing.assert_allclose(fm.as_np(m), dense @ B, rtol=1e-5)
    np.testing.assert_allclose(fm.as_np(g), dense.T @ dense, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_glm_matches_dense_oracle(backend):
    """Logistic regression over the one-hot design equals the dense-engine
    fit (both float32 IRLS) and the JAX package's sparse fit."""
    from repro.algorithms.glm import glm as jglm
    from repro_torch.algorithms import glm
    rng = np.random.default_rng(5)
    n = 2500
    X, dense = _one_hot_case(seed=5, n=n, levels=(13, 7, 5))
    true_b = rng.normal(0, 0.7, dense.shape[1])
    p = 1.0 / (1.0 + np.exp(-(dense @ true_b)))
    yn = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)
    y = fm.conv_R2FM(yn)
    oracle = glm(fm.conv_R2FM(dense), y, "logistic", ridge=1e-3,
                 backend="torch")
    fm.reset_exec_stats()
    r = glm(X, y, "logistic", ridge=1e-3, backend=backend)
    assert np.abs(r.beta - oracle.beta).max() < 1e-2
    assert abs(r.loglik - oracle.loglik) < 1e-3 * abs(oracle.loglik)
    st = fm.exec_stats()
    assert st["passes"] == st["materialize_calls"] == r.iters
    J, _ = _one_hot_case(seed=5, n=n, levels=(13, 7, 5), pkg=jfm)
    jr = jglm(J, jfm.conv_R2FM(yn), "logistic", ridge=1e-3,
              backend="pallas" if backend == "cuda" else "xla")
    assert abs(r.loglik - jr.loglik) < 1e-5 * abs(jr.loglik)


def test_sparse_glm_dispatches_the_spmm_kernels():
    from repro_torch.algorithms.glm import glm_iteration_plan
    X, _ = _one_hot_case(seed=6, n=400)
    y = fm.conv_R2FM(np.ones((400, 1), np.float32))
    plan = glm_iteration_plan(X, y, np.zeros(X.ncol), "logistic")
    assert sorted(u.kernel for u in plan.program("cuda").kernel_units) == [
        "spmm_wgram", "spmm_xty"]
    assert plan.bytes_in() == X.m.nbytes() + 400 * 4
    assert any(s.density < 1.0 for s in plan.ir.segments)


def test_sparse_signature_differs_from_dense():
    X, dense = _one_hot_case(seed=10, n=100)
    D = fm.conv_R2FM(dense)
    assert (Plan([fm.crossprod(X).m]).signature()
            != Plan([fm.crossprod(D).m]).signature())
    X2, _ = _one_hot_case(seed=11, n=100)
    assert (Plan([fm.crossprod(X).m]).signature()
            == Plan([fm.crossprod(X2).m]).signature())


def test_sparse_leaf_arriving_dense_raises():
    """No dense detour: an spmm unit handed a dense block for its sparse
    operand raises instead of computing around the kernel."""
    X, dense = _one_hot_case(seed=12, n=50)
    plan = Plan([fm.crossprod(X).m])
    prog = plan.program("cuda")
    (unit,) = prog.kernel_units
    assert isinstance(unit, lowering.SpmmUnit) and unit.kernel == "spmm_gram"
    blocks = {unit.x_id: torch.from_numpy(dense)}
    with pytest.raises(TypeError, match="ELL block"):
        prog.step(blocks, plan.small_values(), {}, 0)
    before = spmm.gram_launches
    fm.materialize(fm.crossprod(X), backend="cuda")
    assert spmm.gram_launches == before       # CPU tensors: plain version
