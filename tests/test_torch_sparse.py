"""The sparse (one-hot) tier of the port, the twins of tests/test_sparse.py:
ELL/CSR conversions, factor and one-hot construction, engine parity with
the dense oracle and with the JAX package under both backends (``cuda``'s
SpMM wrappers run their plain versions on the CPU), sparse GLM against the
dense fit, and the plan-cache signature — in ``whole`` mode on the device
tier (``fm.one_hot(..., host=False)``); then the host-RAM ELL slab that
``fm.one_hot``'s default builds: the one-hot oracle, the row-local and
sink parity in ``stream`` mode and the crossprod and GLM in ``ooc`` mode
from the host slab (the reference's ooc cells read a CSR ``.fmat``), the
host half of ``test_persist_physical_tiers``, and the config surface
(``test_conf_scoped_override_restores``,
``test_set_conf_rejects_unknown_knob_with_hint``), each against the
reference with the counters of ``helpers_twin.both``; and the disk half:
the CSR ``.fmat`` round trip, crossprod and GLM ``ooc`` from a CSR file
(each package writes its own, byte for byte the same), the disk halves of
the ``fm.persist`` cells, the deprecated ``conv_store`` /
``set_mate_level`` shims, factor ingest and the ingest paths that leave no
partial file, and the bytes an ``ooc`` stream of a CSR file moves.  The
mesh cell (``test_sparse_mesh_parity_subprocess``) runs both packages in
one subprocess under four forced host devices, the port over
``Mesh([cpu] × 4)``."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from helpers_twin import data_dirs, time_limit  # noqa: F401
from repro.core import fm as jfm
from repro_torch.core import fm
from repro_torch.core import lowering
from repro_torch.core.fusion import Plan
from repro_torch.core.sparse import (SparseBlock, csr_from_dense,
                                     csr_from_ell, ell_from_csr_rows)
from repro_torch.kernels import spmm
from repro_torch.observability import metrics

pytestmark = pytest.mark.usefixtures("time_limit")

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


@pytest.mark.parametrize("case", ["one_hot", "ragged"])
def test_ell_csr_conversions_match_the_reference(case):
    """The port's conversions against the reference's, array for array: a
    one-hot slab (every row full, the port's one-copy path) and ragged rows
    with empty ones (the scatter path), over row windows."""
    from repro.core import sparse as jsp
    rng = np.random.default_rng(7)
    if case == "one_hot":
        cols = rng.integers(0, 40, (300, 4)).astype(np.int32)
        vals = np.ones((300, 4), np.float32)
    else:
        d = rng.normal(size=(300, 11)).astype(np.float32)
        d *= rng.random(d.shape) < 0.3
        d[::7] = 0.0
        blk = ell_from_csr_rows(*csr_from_dense(d), 0, 300,
                                int(np.diff(csr_from_dense(d)[0]).max()), 11)
        cols, vals = blk.cols, blk.vals
    got, want = csr_from_ell(cols, vals), jsp.csr_from_ell(cols, vals)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    kmax = cols.shape[1]
    for start, stop in [(0, 300), (13, 14), (40, 257), (299, 300), (5, 5)]:
        t = ell_from_csr_rows(*got, start, stop, kmax, 40)
        r = jsp.ell_from_csr_rows(*want, start, stop, kmax, 40)
        np.testing.assert_array_equal(t.cols, np.asarray(r.cols))
        np.testing.assert_array_equal(t.vals, np.asarray(r.vals))
        assert t.cols.dtype == np.int32 and t.cols.shape == (stop - start,
                                                             kmax)


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


# ---------------------------------------------------------------------------
# Dispatch visibility: SpMM claims + decline reasons (fm.explain)
# ---------------------------------------------------------------------------

#: The reference's explain words → the port's (test_torch_observability).
_EXPLAIN_NAME_MAP = (("backend=xla", "backend=torch"),
                     ("backend=pallas", "backend=cuda"),
                     ("xla generic trace", "torch generic rules"),
                     ("pallas:", "cuda:"),
                     ("generic trace (", "generic rules ("))


def _explain_both(program, backend):
    """``fm.explain`` of ``program(fm)`` in each package (the reference on
    ``pallas`` or ``xla`` for the port's ``cuda`` or ``torch``), node ids
    normalized: (reference text mapped to the port's words, port text)."""
    import re
    texts = []
    for pkg, be in ((jfm, {"cuda": "pallas", "torch": "xla"}[backend]),
                    (fm, backend)):
        texts.append(re.sub(r"#\d+", "#N",
                            pkg.explain(*program(pkg), backend=be)))
    for old, new in _EXPLAIN_NAME_MAP:
        texts[0] = texts[0].replace(old, new)
    return texts


def test_explain_shows_spmm_claims():
    from repro.algorithms.glm import glm_irls_outputs as jglm_outputs
    from repro_torch.algorithms.glm import glm_irls_outputs

    def gram(pkg):
        return [pkg.crossprod(_host_case(pkg, seed=6, n=400))]

    want, text = _explain_both(gram, "cuda")
    assert "cuda:spmm_gram (claimed by match_spmm)" in text
    assert "density=" in text
    assert text == want

    def irls(pkg):
        X = _host_case(pkg, seed=6, n=400)
        y = pkg.conv_R2FM(np.ones((400, 1), np.float32))
        outs = (glm_irls_outputs if pkg is fm else jglm_outputs)(
            X, y, np.zeros(X.ncol), "logistic")
        return outs[:2]

    want, text = _explain_both(irls, "cuda")
    assert "cuda:spmm_wgram" in text
    assert "cuda:spmm_xty" in text
    assert text == want


def test_explain_reports_decline_reasons():
    """A fallback segment says why — here a (mul,max) semiring over a
    sparse source declines both the spmm and dense matchers."""
    def semiring(pkg):
        X = _host_case(pkg, seed=7, n=200)
        return [pkg.inner_prod(X.T, X, "mul", "max")]

    want, text = _explain_both(semiring, "cuda")
    assert "generic rules (declined:" in text
    assert "spmm covers (mul,sum) only" in text
    assert text == want
    # The torch backend has no matchers: its line is the golden one.
    want, text = _explain_both(semiring, "torch")
    assert "torch generic rules" in text
    assert text == want


# ---------------------------------------------------------------------------
# The host-RAM ELL slab (fm.one_hot's default), against the reference
# ---------------------------------------------------------------------------

def _host_case(side_fm, seed=0, n=600, levels=(7, 5, 11)):
    codes = _codes(seed, n, levels)
    return side_fm.one_hot(*[side_fm.as_factor(c, lv)
                             for c, lv in zip(codes, levels)])


def test_one_hot_default_is_the_host_slab():
    """``fm.one_hot``'s default, as the reference's test calls it: the
    slab in host RAM (numpy cols / vals), equal to the dense oracle and to
    the reference's."""
    X = _host_case(fm)
    _, dense = _one_hot_case()
    assert X.m.is_sparse and X.m.on_host and X.shape == dense.shape
    assert isinstance(X.m.store.cols, np.ndarray)
    assert X.m.nbytes() == _host_case(jfm).m.nbytes()
    np.testing.assert_array_equal(fm.as_np(X), dense)
    np.testing.assert_array_equal(fm.as_np(X), jfm.as_np(_host_case(jfm)))
    with pytest.raises(ValueError, match="lengths differ"):
        fm.one_hot(fm.as_factor(np.arange(4)), fm.as_factor(np.arange(5)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_rowlocal_and_sinks_parity_host_slab(backend):
    """The reference's cell as written — ``stream`` mode over the default
    one_hot — with the counters and kernel dispatch of both packages
    equal."""
    from helpers_twin import both, both_conf
    _, dense = _one_hot_case(seed=4)
    B = np.full((23, 2), 0.5, np.float32)

    def program(f):
        X = _host_case(f, seed=4)
        return [X * 3.0 - 1.0, f.colSums(X), X @ B]

    with both_conf(io_partition_bytes=2048):
        ref, (zm, s, m) = both(program, backend=backend, mode="stream")
    np.testing.assert_allclose(zm, dense * 3.0 - 1.0, rtol=1e-5)
    np.testing.assert_allclose(s.reshape(-1), dense.sum(0), rtol=1e-5)
    np.testing.assert_allclose(m, dense @ B, rtol=1e-5)
    for r, t in zip(ref, (zm, s, m)):
        np.testing.assert_allclose(t, r, rtol=1e-6)


@pytest.mark.parametrize("mode", ["ooc", "whole"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_crossprod_parity_host_slab(backend, mode):
    """crossprod over the host slab: ``ooc`` streams it through the
    prefetcher a partition at a time, ``whole`` stages it once; equal to
    the oracle, to the reference, and to each other bit for bit."""
    from helpers_twin import both, both_conf
    _, dense = _one_hot_case(seed=3)
    fm.reset_exec_stats()
    with both_conf(io_partition_bytes=2048):
        ref, (g,) = both(lambda f: [f.crossprod(_host_case(f, seed=3))],
                         backend=backend, mode=mode)
        st = fm.exec_stats()
    np.testing.assert_allclose(g, dense.T.astype(np.float64) @ dense,
                               rtol=1e-4)
    np.testing.assert_allclose(g, ref[0], rtol=1e-6)
    (gw,) = fm.materialize(fm.crossprod(_host_case(fm, seed=3)),
                           mode="whole", backend=backend)
    np.testing.assert_array_equal(g, fm.as_np(gw))
    assert (st["partition_steps"] > st["passes"]) == (mode == "ooc")


def test_sparse_glm_ooc_host_slab_matches_dense_oracle():
    """The reference's capstone with the host slab in place of its CSR
    ``.fmat``: logistic regression out of core equals the dense fit and the
    reference's, on both backends, the SpMM kernels dispatched."""
    from repro.algorithms.glm import glm as jglm
    from repro_torch.algorithms import glm
    rng = np.random.default_rng(5)
    n = 2500
    _, dense = _one_hot_case(seed=5, n=n, levels=(13, 7, 5))
    true_b = rng.normal(0, 0.7, dense.shape[1])
    p = 1.0 / (1.0 + np.exp(-(dense @ true_b)))
    yn = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)
    y = fm.conv_R2FM(yn)
    oracle = glm(fm.conv_R2FM(dense), y, "logistic", ridge=1e-3,
                 mode="whole", backend="torch")
    Xh = _host_case(fm, seed=5, n=n, levels=(13, 7, 5))
    J = _host_case(jfm, seed=5, n=n, levels=(13, 7, 5))
    with fm.conf(io_partition_bytes=1 << 14), \
            jfm.conf(io_partition_bytes=1 << 14):
        jr = jglm(J, jfm.conv_R2FM(yn), "logistic", ridge=1e-3, mode="ooc")
        for backend in BACKENDS:
            fm.reset_exec_stats()
            r = glm(Xh, y, "logistic", ridge=1e-3, mode="ooc",
                    backend=backend)
            st = fm.exec_stats()
            assert st["partition_steps"] > st["passes"] == r.iters
            assert np.abs(r.beta - oracle.beta).max() < 1e-2, backend
            assert abs(r.loglik - oracle.loglik) < 1e-3 * abs(oracle.loglik)
            assert abs(r.loglik - jr.loglik) < 1e-5 * abs(jr.loglik)


def test_persist_physical_tiers_host():
    """The host half of the reference's cell: a dense matrix and a one-hot
    slab persisted to host RAM, in both packages; the slab stays sparse
    (cols / vals move, never densified) and moves back to the device."""
    A = np.arange(12, dtype=np.float32).reshape(4, 3)
    _, dense = _one_hot_case(seed=8, n=150)
    for f in (jfm, fm):
        X = f.conv_R2FM(A)
        Xh = f.persist(X, tier="host")
        assert Xh.m.on_host and not Xh.m.on_disk
        np.testing.assert_array_equal(f.as_np(Xh), A)
        with pytest.raises(ValueError, match="unknown tier"):
            f.persist(X, tier="ssd")
    S = fm.one_hot(*[fm.as_factor(c, lv) for c, lv in
                     zip(_codes(8, 150, (7, 5, 11)), (7, 5, 11))],
                   host=False)
    Sh = fm.persist(S, tier="host")
    assert Sh.m.is_sparse and Sh.m.on_host
    assert isinstance(Sh.m.store.vals, np.ndarray)
    assert Sh.m.nbytes() == S.m.nbytes()
    np.testing.assert_array_equal(fm.as_np(Sh), dense)
    Sd = fm.persist(Sh, tier="device")
    assert Sd.m.is_sparse and not Sd.m.on_host
    np.testing.assert_array_equal(fm.as_np(Sd), dense)


def test_set_conf_rejects_unknown_knob_with_hint():
    for f in (jfm, fm):
        with pytest.raises(ValueError, match="did you mean 'prefetch'"):
            f.set_conf(prefetsh=True)
        with pytest.raises(ValueError, match="known knobs"):
            f.set_conf(not_even_close=1)


def test_conf_scoped_override_restores():
    from repro_torch.core import lowering as lowering_mod
    from repro_torch.core import matrix as matrix_mod
    old_backend = lowering_mod.DEFAULT_BACKEND
    old_bytes = matrix_mod.IO_PARTITION_BYTES
    with fm.conf(backend="cuda", io_partition_bytes=4096) as live:
        assert live["backend"] == "cuda"
        assert matrix_mod.IO_PARTITION_BYTES == 4096
    assert lowering_mod.DEFAULT_BACKEND == old_backend
    assert matrix_mod.IO_PARTITION_BYTES == old_bytes
    # Restores on error too.
    with pytest.raises(RuntimeError):
        with fm.conf(io_partition_bytes=8192):
            raise RuntimeError("boom")
    assert matrix_mod.IO_PARTITION_BYTES == old_bytes
    with pytest.raises(ValueError, match="unknown config knob"):
        with fm.conf(backnd="torch"):
            pass


# ---------------------------------------------------------------------------
# The disk half: the CSR .fmat, persist(tier="disk"), ingest, the shims
# ---------------------------------------------------------------------------

@pytest.fixture()
def disk(data_dirs):
    """Both packages' registries in fresh directories; the reference's
    plan cache cleared around the test as the port's is."""
    from repro.core import materialize as jmz
    jmz.clear_plan_cache()
    yield data_dirs
    jmz.clear_plan_cache()


def test_csr_fmat_roundtrip(tmp_path):
    from repro_torch import storage
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(97, 13)).astype(np.float32)
    dense *= rng.random(dense.shape) < 0.3
    indptr, indices, data = csr_from_dense(dense)
    path = tmp_path / "m.fmat"
    meta = storage.save_csr_matrix(path, indptr, indices, data, ncol=13)
    assert meta["format"] == "csr" and meta["nnz"] == int(indptr[-1])
    st = storage.open_csr(path)
    assert st.sparse and st.shape == (97, 13)
    np.testing.assert_array_equal(st.logical(), dense)
    blk = st.block(10, 40)
    assert isinstance(blk, SparseBlock) and blk.kmax == st.max_row_nnz
    assert isinstance(blk.cols, np.ndarray) and blk.cols.dtype == np.int32
    np.testing.assert_array_equal(blk.todense(), dense[10:40])
    st2 = storage.open_matrix(path)
    assert isinstance(st2, storage.CsrMmapStore)
    assert storage.peek_format(path) == "csr"
    with pytest.raises(ValueError, match="csr"):
        storage.read_header(path)
    with pytest.raises(ValueError, match="out of range"):
        storage.save_csr_matrix(tmp_path / "bad.fmat", indptr, indices,
                                data, ncol=5)


def test_sparse_nbytes_on_disk_is_nnz_proportional(disk):
    X = _host_case(fm, n=400, levels=(1000, 1000))
    Xd = fm.persist(X, tier="disk", name="wide")
    J = jfm.persist(_host_case(jfm, n=400, levels=(1000, 1000)),
                    tier="disk", name="wide")
    assert Xd.m.nbytes() == J.m.nbytes() == 401 * 8 + 800 * 8
    assert Xd.m.nbytes() < 400 * 2000 * 4 / 50
    assert (disk["repro"] / "wide.fmat").read_bytes() == \
        (disk["repro_torch"] / "wide.fmat").read_bytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_crossprod_parity_csr_file(disk, backend):
    """The reference's ``ooc`` cell: crossprod of a CSR ``.fmat`` streamed
    a partition at a time (the prefetcher on), equal to the oracle, to the
    reference with equal counters, and to whole mode bit for bit."""
    from helpers_twin import both, both_conf, counting
    from helpers_twin import PORT
    _, dense = _one_hot_case(seed=3)
    for f in (jfm, fm):
        f.persist(_host_case(f, seed=3), tier="disk", name="par")
    with both_conf(io_partition_bytes=2048):
        with counting(PORT, ("passes", "partition_steps")) as st:
            ref, (g,) = both(lambda f: [f.crossprod(
                f.get_dense_matrix("par"))], backend=backend, mode="ooc")
    assert st["partition_steps"] > st["passes"] == 1
    np.testing.assert_allclose(g, dense.T.astype(np.float64) @ dense,
                               rtol=1e-4)
    np.testing.assert_allclose(g, ref[0], rtol=1e-6)
    (gw,) = fm.materialize(fm.crossprod(fm.get_dense_matrix("par")),
                           mode="whole", backend=backend)
    np.testing.assert_array_equal(g, fm.as_np(gw))


def test_sparse_glm_ooc_matches_dense_oracle(disk):
    """The capstone: logistic regression out of core from a CSR .fmat
    equals the dense fit and the reference's, on both backends."""
    from repro.algorithms.glm import glm as jglm
    from repro_torch.algorithms import glm
    rng = np.random.default_rng(5)
    n = 2500
    _, dense = _one_hot_case(seed=5, n=n, levels=(13, 7, 5))
    true_b = rng.normal(0, 0.7, dense.shape[1])
    p = 1.0 / (1.0 + np.exp(-(dense @ true_b)))
    yn = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)
    y = fm.conv_R2FM(yn)
    oracle = glm(fm.conv_R2FM(dense), y, "logistic", ridge=1e-3,
                 mode="whole", backend="torch")
    Xd = fm.persist(_host_case(fm, seed=5, n=n, levels=(13, 7, 5)),
                    tier="disk", name="glm")
    J = jfm.persist(_host_case(jfm, seed=5, n=n, levels=(13, 7, 5)),
                    tier="disk", name="glm")
    assert Xd.m.on_disk and Xd.m.is_sparse
    with fm.conf(io_partition_bytes=1 << 14), \
            jfm.conf(io_partition_bytes=1 << 14):
        jr = jglm(J, jfm.conv_R2FM(yn), "logistic", ridge=1e-3, mode="ooc")
        for backend in BACKENDS:
            fm.reset_exec_stats()
            r = glm(Xd, y, "logistic", ridge=1e-3, mode="ooc",
                    backend=backend)
            st = fm.exec_stats()
            assert st["partition_steps"] > st["passes"] == r.iters
            assert np.abs(r.beta - oracle.beta).max() < 1e-2, backend
            assert abs(r.loglik - oracle.loglik) < 1e-3 * abs(oracle.loglik)
            assert abs(r.loglik - jr.loglik) < 1e-5 * abs(jr.loglik)


def test_persist_physical_tiers_disk(disk):
    """The disk half of the reference's cell, in both packages: a dense
    host matrix persisted to disk by name reads back; the files agree."""
    A = np.arange(12, dtype=np.float32).reshape(4, 3)
    for f in (jfm, fm):
        Xh = f.persist(f.conv_R2FM(A), tier="host")
        Xd = f.persist(Xh, tier="disk", name="p1")
        assert Xd.m.on_disk
        np.testing.assert_array_equal(f.as_np(f.get_dense_matrix("p1")), A)
        with pytest.raises(ValueError, match="unknown tier"):
            f.persist(Xh, tier="ssd")
    Xd = fm.persist(fm.conv_R2FM(A), tier="disk", name="p2")  # from device
    np.testing.assert_array_equal(fm.as_np(Xd), A)
    assert (disk["repro"] / "p1.fmat").read_bytes() == \
        (disk["repro_torch"] / "p1.fmat").read_bytes() == \
        (disk["repro_torch"] / "p2.fmat").read_bytes()


def test_persist_virtual_marks_save(disk):
    A = np.arange(20, dtype=np.float32).reshape(5, 4)
    for f in (jfm, fm):
        Z = f.conv_R2FM(A) * 2.0
        out = f.persist(Z, tier="disk")
        assert out is Z and Z.m.node.save == "disk"
        (Zm,) = f.materialize(Z)
        assert Zm.m.on_disk
        np.testing.assert_allclose(f.as_np(Zm), A * 2.0, rtol=1e-6)


def test_persist_sparse_roundtrips_sparse(disk):
    from repro_torch import storage
    _, dense = _one_hot_case(seed=8, n=150)
    for X in (_host_case(fm, seed=8, n=150),
              _one_hot_case(seed=8, n=150)[0]):      # host slab, device slab
        Xd = fm.persist(X, tier="disk", name="sp")
        assert isinstance(Xd.m.store, storage.CsrMmapStore)
        Xh = fm.persist(Xd, tier="host")
        assert isinstance(Xh.m.store, storage.SparseEllStore)
        assert Xh.m.on_host
        np.testing.assert_array_equal(fm.as_np(Xh), dense)
        assert fm.get_dense_matrix("sp").m.is_sparse
        Xdev = fm.persist(Xd, tier="device")
        assert Xdev.m.is_sparse and not Xdev.m.on_host
        np.testing.assert_array_equal(fm.as_np(Xdev), dense)
    jfm.persist(_host_case(jfm, seed=8, n=150), tier="disk", name="sp")
    assert (disk["repro"] / "sp.fmat").read_bytes() == \
        (disk["repro_torch"] / "sp.fmat").read_bytes()


def test_deprecated_spellings_warn_and_delegate(disk):
    import warnings
    A = np.arange(12, dtype=np.float32).reshape(4, 3)
    for f in (jfm, fm):
        with pytest.warns(DeprecationWarning, match="fm.persist"):
            Xd = f.conv_store(f.conv_R2FM(A), "disk", name="old1")
        assert Xd.m.on_disk
        Z = f.conv_R2FM(A) + 1.0
        with pytest.warns(DeprecationWarning, match="fm.persist"):
            f.set_mate_level(Z, "disk")
        assert Z.m.node.save == "disk"
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            f.persist(f.conv_R2FM(A), tier="host")
            f.scale(f.conv_R2FM(A), save="disk")


def test_ingest_factor_csv_roundtrip(disk, tmp_path):
    rng = np.random.default_rng(9)
    codes = np.stack([rng.integers(0, 6, 500), rng.integers(0, 4, 500)], 1)
    csv = tmp_path / "f.csv"
    np.savetxt(csv, codes, fmt="%d", delimiter=",")
    dense = np.zeros((500, 10), np.float32)
    dense[np.arange(500), codes[:, 0]] = 1.0
    dense[np.arange(500), 6 + codes[:, 1]] = 1.0
    for f in (jfm, fm):
        X = f.load_factor_matrix(str(csv), "criteo_mini", num_levels=[6, 4],
                                 chunk_rows=64)
        assert X.m.is_sparse and X.m.on_disk and X.shape == (500, 10)
        np.testing.assert_array_equal(f.as_np(X), dense)
    assert (disk["repro"] / "criteo_mini.fmat").read_bytes() == \
        (disk["repro_torch"] / "criteo_mini.fmat").read_bytes()


def test_ingest_factor_cardinality_overflow(disk, tmp_path):
    from repro_torch import storage
    codes = np.array([[0, 1], [2, 9]])
    csv = tmp_path / "bad.csv"
    np.savetxt(csv, codes, fmt="%d", delimiter=",")
    with pytest.raises(ValueError, match="cardinality overflow"):
        fm.load_factor_matrix(str(csv), "overflow", num_levels=[3, 4])
    dest = storage.registry.matrix_path("overflow")
    assert not dest.exists(), "partial .fmat left behind"
    assert not list(dest.parent.glob("*.tmp")), "sidecar temp left behind"


def test_ingest_csv_malformed_rows_no_partial(disk, tmp_path):
    from repro_torch import storage
    csv = tmp_path / "mal.csv"
    csv.write_text("1.0,2.0\n3.0,not_a_number\n")
    with pytest.raises(ValueError, match="malformed CSV"):
        fm.load_dense_matrix(str(csv), "mal")
    assert not storage.registry.matrix_path("mal").exists()


def test_ingest_csv_ragged_rows_no_partial(disk, tmp_path):
    from repro_torch import storage
    csv = tmp_path / "rag.csv"
    rows = ["1.0,2.0"] * 5 + ["1.0,2.0,3.0"]
    csv.write_text("\n".join(rows) + "\n")
    with pytest.raises(ValueError, match="ragged"):
        fm.load_dense_matrix(str(csv), "rag", chunk_rows=2)
    assert not storage.registry.matrix_path("rag").exists()


def test_ingest_binary_dtype_mismatch_no_partial(disk, tmp_path):
    from repro_torch import storage
    raw = tmp_path / "odd.bin"
    raw.write_bytes(b"\x00" * 10)
    with pytest.raises(ValueError, match="whole number"):
        fm.load_dense_matrix(str(raw), "oddbin", ncol=3)
    assert not storage.registry.matrix_path("oddbin").exists()


def test_sparse_stream_moves_nnz_bytes(disk):
    """An ooc stream of a CSR file counts ELL bytes read and CSR bytes a
    pass, never nrow·ncol·itemsize — equal to the reference's counts."""
    from helpers_twin import both, both_conf, counting
    from helpers_twin import PORT, REF
    _, dense = _one_hot_case(seed=11, n=3000, levels=(500, 400))
    for f in (jfm, fm):
        f.persist(_host_case(f, seed=11, n=3000, levels=(500, 400)),
                  tier="disk", name="acct")
    with both_conf(io_partition_bytes=1 << 14):
        with fm.collect_stats() as sc:
            both(lambda f: [f.crossprod(f.get_dense_matrix("acct"))],
                 mode="ooc")
    moved = sc.stats()["stage_bytes_read"]
    assert 0 < moved < dense.nbytes / 10, (moved, dense.nbytes)
    assert moved == 3000 * 2 * 8           # the ELL slab: cols + vals
    Xd = fm.get_dense_matrix("acct")
    assert fm.exec_stats()["pass_bytes_in"] == (Xd.m.nbytes(),)
    assert Xd.m.nbytes() == 3001 * 8 + 6000 * 8


# ---------------------------------------------------------------------------
# The mesh cell: both packages in one subprocess under 4 forced devices
# ---------------------------------------------------------------------------

_SPARSE_MESH = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, torch
    from repro.core import fm as jfm
    from repro.launch.mesh import make_host_mesh
    from repro_torch.core import fm as tfm
    from repro_torch.launch.mesh import Mesh

    tfm.set_conf(device="cpu")
    out = {}
    for name, fm, mesh, kw in (
            ("repro", jfm, make_host_mesh(4), {}),
            ("repro_torch", tfm, Mesh([torch.device("cpu")] * 4, ("data",)),
             {"host": False})):
        fm.set_conf(data_dir=os.path.join(sys.argv[1], name))
        rng = np.random.default_rng(3)
        codes = [rng.integers(0, 9, 2000), rng.integers(0, 6, 2000)]
        X = fm.one_hot(*[fm.as_factor(c) for c in codes], **kw)
        dense = fm.as_np(X).copy()
        want = dense.T.astype(np.float64) @ dense
        fm.set_conf(io_partition_bytes=4096)
        Xd = fm.persist(X, tier="disk", name="mesh_oh")
        rec = {"sparse": bool(X.m.store.sparse and Xd.m.store.sparse)}
        fm.reset_exec_stats()
        (g,) = fm.materialize(fm.crossprod(X), mode="whole", mesh=mesh)
        np.testing.assert_allclose(fm.as_np(g), want, rtol=1e-3)
        rec["whole"] = fm.exec_stats()
        with fm.conf(mesh=mesh):
            for src, mode in ((X, "stream"), (Xd, "ooc")):
                fm.reset_exec_stats()
                (g,) = fm.materialize(fm.crossprod(src), mode=mode)
                np.testing.assert_allclose(fm.as_np(g), want, rtol=1e-3)
                rec[mode] = fm.exec_stats()
                assert rec[mode]["shards"] == 4
        out[name] = rec
    print(json.dumps(out))
""")


def test_sparse_mesh_parity_subprocess(tmp_path):
    """Sharded execution over a 4-device mesh: sparse crossprod in
    whole / stream / ooc matches the dense oracle in both packages (the
    reference's own assertions, run on each side), with the execution
    counters — ``shards``, ``shard_merges``, ``shard_bytes_in`` among them
    — equal to the reference's."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _SPARSE_MESH, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ref, port = got["repro"], got["repro_torch"]
    assert port["sparse"] and ref["sparse"]
    for mode in ("whole", "stream", "ooc"):
        assert port[mode] == ref[mode], (mode, port[mode], ref[mode])
    assert port["stream"]["shard_merges"] == 3
