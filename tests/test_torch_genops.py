"""Twin of tests/test_genops.py: every GenOp on the port held against the
JAX package and the same numpy oracle, whole mode on the device tier.

Each test builds the reference test's program in both packages from the
same numpy inputs (``helpers_twin.both``: equal counters, kernel dispatch,
shapes and dtypes) and holds both outputs to the reference's oracle and
tolerance.  The reference's ``("stream", device)`` and ``("whole", host)``
cells of its three parametrized classes are ``test_stream_and_host_cells``:
the same test bodies with their sources on that tier, in that mode.
"""
import inspect

import numpy as np
import pytest

from helpers_twin import PORT, REF, _port_on_cpu, both  # noqa: F401
from helpers_twin import data_dirs  # noqa: F401
from helpers_twin import time_limit  # noqa: F401
from repro.core import fm as jfm
from repro_torch.core import fm as tfm

pytestmark = pytest.mark.usefixtures("time_limit")

RNG = np.random.default_rng(7)


def data(n=257, p=9, dtype=np.float32):
    return (RNG.normal(size=(n, p)) * 3).astype(dtype)


def twins(program, check, **kw):
    """Run ``program`` in both packages and apply ``check(outputs)`` to
    each side's outputs."""
    for side, outs in zip((REF, PORT), both(program, **kw)):
        try:
            check(*outs)
        except AssertionError as e:
            raise AssertionError(f"{side.name}: {e}") from None


class TestElementwise:
    def test_sapply_chain(self, mode="whole", host=False):
        Xn = data()
        twins(lambda fm: [fm.sqrt(fm.abs_(
                  fm.conv_R2FM(Xn, host=host) * 2.0 + 1.0))],
              lambda m: np.testing.assert_allclose(
                  m, np.sqrt(np.abs(Xn * 2 + 1)), rtol=1e-5), mode=mode)

    def test_mapply_matrix(self, mode="whole", host=False):
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            Y = fm.conv_R2FM(Xn * 0.5 + 1, host=host)
            return [X * Y - Y]

        twins(program, lambda m: np.testing.assert_allclose(
            m, Xn * (Xn * 0.5 + 1) - (Xn * 0.5 + 1), rtol=1e-4), mode=mode)

    def test_scalar_forms(self, mode="whole", host=False):
        """bVUDF2 (vec∘scalar) and bVUDF3 (scalar∘vec)."""
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [X - 3.0, 3.0 - X]

        def check(a, b):
            np.testing.assert_allclose(a, Xn - 3.0, rtol=1e-6)
            np.testing.assert_allclose(b, 3.0 - Xn, rtol=1e-6)

        twins(program, check, mode=mode)

    def test_mapply_row_col(self, mode="whole", host=False):
        Xn = data()
        row = RNG.normal(size=Xn.shape[1]).astype(np.float32)
        col = RNG.normal(size=Xn.shape[0]).astype(np.float32)

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [fm.mapply_row(X, row, "mul"), fm.mapply_col(X, col, "add")]

        def check(a, b):
            np.testing.assert_allclose(a, Xn * row[None], rtol=1e-5)
            np.testing.assert_allclose(b, Xn + col[:, None], rtol=1e-5)

        twins(program, check, mode=mode)

    def test_pmin_pmax_ifelse0(self, mode="whole", host=False):
        Xn = data()

        def program(fm):
            X, Y = fm.conv_R2FM(Xn, host=host), fm.conv_R2FM(-Xn, host=host)
            return [fm.pmin(X, Y), fm.pmax(X, Y)]

        def check(mn, mx):
            np.testing.assert_allclose(mn, np.minimum(Xn, -Xn))
            np.testing.assert_allclose(mx, np.maximum(Xn, -Xn))

        twins(program, check, mode=mode)

    def test_cbind(self, mode="whole", host=False):
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [fm.cbind(X, X * 2.0)]

        twins(program, lambda m: np.testing.assert_allclose(
            m, np.concatenate([Xn, Xn * 2], 1), rtol=1e-6), mode=mode)


class TestAggregation:
    def test_agg_full(self, mode="whole", host=False):
        Xn = data()
        twins(lambda fm: [fm.sum_(fm.conv_R2FM(Xn, host=host))],
              lambda s: np.testing.assert_allclose(s.reshape(()), Xn.sum(),
                                                   rtol=1e-4), mode=mode)

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_agg_col_variants(self, backend, mode="whole", host=False):
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [fm.colSums(X), fm.colMins(X), fm.colMaxs(X),
                    fm.agg_col(X, "count_nonzero")]

        def check(s, mn, mx, nz):
            np.testing.assert_allclose(s.ravel(), Xn.sum(0), rtol=1e-4)
            np.testing.assert_allclose(mn.ravel(), Xn.min(0))
            np.testing.assert_allclose(mx.ravel(), Xn.max(0))
            np.testing.assert_array_equal(nz.ravel(), (Xn != 0).sum(0))

        twins(program, check, backend=backend, mode=mode)

    def test_agg_row(self, mode="whole", host=False):
        Xn = data()
        twins(lambda fm: [fm.rowSums(fm.conv_R2FM(Xn, host=host))],
              lambda s: np.testing.assert_allclose(s.ravel(), Xn.sum(1),
                                                   rtol=1e-4), mode=mode)

    @pytest.mark.parametrize("p", [2, 9, 17])
    def test_row_sums_round_as_the_reference(self, p):
        """An f32 row sum adds the columns in the reference's order, so it
        equals the reference's bit for bit (torch.sum's tree did not on
        about half the rows, beyond an rtol-only check where a row
        cancels: ROADMAP §C, C5)."""
        Xn = (np.random.default_rng(p).normal(size=(4000, p)) * 3) \
            .astype(np.float32)
        ref, port = both(lambda fm: [fm.rowSums(fm.conv_R2FM(Xn)),
                                     fm.agg_row(fm.conv_R2FM(Xn), "sum")])
        for r, t in zip(ref, port):
            np.testing.assert_array_equal(t, r)

    def test_which_min_row_absolute_indices(self, mode="whole", host=False):
        """Indexed reductions must stay absolute across partitions."""
        Xn = data()
        twins(lambda fm: [fm.which_min_row(fm.conv_R2FM(Xn, host=host))],
              lambda w: np.testing.assert_array_equal(w.ravel(),
                                                      Xn.argmin(1)),
              mode=mode)

    def test_logsumexp_streaming(self, mode="whole", host=False):
        Xn = data()
        ref = np.log(np.exp(Xn - Xn.max(1, keepdims=True)).sum(1)) + Xn.max(1)
        twins(lambda fm: [fm.agg_row(fm.conv_R2FM(Xn, host=host),
                                     "logsumexp")],
              lambda l: np.testing.assert_allclose(l.ravel(), ref, rtol=1e-5),
              mode=mode)

    def test_any_all(self, mode="whole", host=False):
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [fm.any_(X > 10.0), fm.all_(X > -100.0)]

        def check(a, b):
            assert bool(a.reshape(())) == bool((Xn > 10).any())
            assert bool(b.reshape(())) == bool((Xn > -100).all())

        twins(program, check, mode=mode)


class TestInnerProdGroupBy:
    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_crossprod(self, backend, mode="whole", host=False):
        Xn = data()
        twins(lambda fm: [fm.crossprod(fm.conv_R2FM(Xn, host=host))],
              lambda g: np.testing.assert_allclose(g, Xn.T @ Xn, rtol=1e-3),
              backend=backend, mode=mode)

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_crossprod_xy(self, backend, mode="whole", host=False):
        Xn, Yn = data(), data()
        twins(lambda fm: [fm.crossprod(fm.conv_R2FM(Xn, host=host),
                                       fm.conv_R2FM(Yn, host=host))],
              lambda g: np.testing.assert_allclose(g, Xn.T @ Yn, rtol=1e-3),
              backend=backend, mode=mode)

    def test_tall_matmul(self, mode="whole", host=False):
        Xn = data()
        W = RNG.normal(size=(Xn.shape[1], 4)).astype(np.float32)
        twins(lambda fm: [fm.conv_R2FM(Xn, host=host) @ W],
              lambda m: np.testing.assert_allclose(m, Xn @ W, rtol=1e-3),
              mode=mode)

    def test_semiring_distance(self, mode="whole", host=False):
        Xn = data()
        C = RNG.normal(size=(Xn.shape[1], 5)).astype(np.float32)
        ref = ((Xn[:, :, None] - C[None]) ** 2).sum(1)
        twins(lambda fm: [fm.inner_prod(fm.conv_R2FM(Xn, host=host), C,
                                        "squared_diff", "sum")],
              lambda m: np.testing.assert_allclose(m, ref, rtol=1e-3),
              mode=mode)

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_groupby_row(self, backend, mode="whole", host=False):
        Xn = data()
        lab = RNG.integers(0, 6, Xn.shape[0])

        def program(fm):
            X = fm.conv_R2FM(Xn, host=host)
            return [fm.rowsum(X, fm.conv_R2FM(lab.astype(np.int32),
                                              host=host), 6),
                    fm.table_(fm.conv_R2FM(lab.astype(np.int32),
                                           host=host), 6)]

        ref = np.zeros((6, Xn.shape[1]), np.float64)
        np.add.at(ref, lab, Xn.astype(np.float64))

        def check(g, c):
            np.testing.assert_allclose(g, ref, rtol=1e-3)
            np.testing.assert_array_equal(c.ravel(),
                                          np.bincount(lab, minlength=6))

        twins(program, check, backend=backend, mode=mode)

    def test_groupby_col(self, mode="whole", host=False):
        Xn = data()
        lab = RNG.integers(0, 3, Xn.shape[1]).astype(np.int32)
        ref = np.zeros((Xn.shape[0], 3), np.float32)
        for j, k in enumerate(lab):
            ref[:, k] += Xn[:, j]
        twins(lambda fm: [fm.groupby_col(fm.conv_R2FM(Xn, host=host), lab,
                                         "sum", 3)],
              lambda g: np.testing.assert_allclose(g, ref, rtol=1e-4),
              mode=mode)


class TestDtypesAndLazy:
    def test_lazy_cast_promotion(self):
        Xi = RNG.integers(0, 100, (64, 3)).astype(np.int32)

        def check(m):
            assert m.dtype == np.float32
            np.testing.assert_allclose(m, Xi * 1.5)

        twins(lambda fm: [fm.conv_R2FM(Xi) * 1.5], check)

    def test_division_promotes(self):
        Xi = RNG.integers(1, 100, (64, 3)).astype(np.int32)
        twins(lambda fm: [fm.conv_R2FM(Xi) / 2],
              lambda m: np.testing.assert_allclose(m, Xi / 2))

    def test_comparison_dtype(self):
        Xn = data()

        def check(m):
            assert m.dtype == np.bool_
            np.testing.assert_array_equal(m, Xn > 0.0)

        twins(lambda fm: [fm.conv_R2FM(Xn) > 0.0], check)

    def test_missing_values_fig5(self):
        """The paper's Fig. 5 workload: std-dev with NA exclusion."""
        Xn = data()
        Xn[Xn > 2.0] = np.nan

        def program(fm):
            X = fm.conv_R2FM(Xn)
            na = fm.is_na(X)
            return [fm.sum_(fm.ifelse0(X, na)), fm.sum_(fm.ifelse0(X ** 2, na)),
                    fm.agg(fm.sapply(na, "not"), "sum")]

        def check(sx, sx2, cnt):
            n = float(cnt.reshape(()))
            mean = float(sx.reshape(())) / n
            var = float(sx2.reshape(())) / n - mean ** 2
            np.testing.assert_allclose(np.sqrt(var), np.nanstd(Xn), rtol=1e-3)

        twins(program, check)

    def test_materialize_flag_reuse(self):
        Xn = data()
        got = []
        for side in (REF, PORT):
            fm = side.fm
            Y = fm.conv_R2FM(Xn) * 2.0
            fm.persist(Y, tier="device")
            fm.materialize(fm.colSums(Y))
            # Y is now cut: reusing it must not recompute from X
            assert Y.m.node.cached_store is not None
            (g,) = fm.materialize(fm.crossprod(Y))
            got.append(fm.as_np(g))
        for g in got:
            np.testing.assert_allclose(g, (Xn * 2).T @ (Xn * 2), rtol=1e-3)

    def test_persist_host_tier(self):
        """fm.persist(tier="host"): a virtual matrix materializes into host
        RAM and is reused as a source from there; a physical one moves
        now."""
        Xn = data()
        got = []
        for side in (REF, PORT):
            fm = side.fm
            X = fm.conv_R2FM(Xn)
            Y = fm.persist(X * 2.0, tier="host")
            (s,) = fm.materialize(fm.colSums(Y))
            store = Y.m.node.cached_store
            assert store.on_host and isinstance(store.store.data, np.ndarray)
            (g,) = fm.materialize(fm.crossprod(Y))
            P = fm.persist(X, tier="host")
            assert P.m.on_host and not X.m.on_host
            np.testing.assert_array_equal(fm.as_np(P), Xn)
            got.append((fm.as_np(s), fm.as_np(g)))
        for (s, g) in got:
            np.testing.assert_allclose(s.ravel(), (Xn * 2).sum(0), rtol=1e-4)
            np.testing.assert_allclose(g, (Xn * 2).T @ (Xn * 2), rtol=1e-3)

    @pytest.mark.parametrize("mode", ["auto", "stream", "whole"])
    def test_unfused_host_intermediates(self, mode):
        """fuse=False over a host source: each node materializes alone, its
        intermediate written to host RAM and read back, in both packages
        with the same counters."""
        Xn = data()

        def program(fm):
            X = fm.conv_R2FM(Xn, host=True)
            return [fm.colSums(fm.abs_(X * 2.0 - 1.0)), X + 1.0]

        def check(s, y):
            np.testing.assert_allclose(s.ravel(), np.abs(Xn * 2 - 1).sum(0),
                                       rtol=1e-4)
            np.testing.assert_allclose(y, Xn + 1.0, rtol=1e-6)

        twins(program, check, mode=mode, fuse=False)

    def test_transpose_roundtrip(self):
        Xn = data()
        for side in (REF, PORT):
            T = side.fm.conv_R2FM(Xn).t()
            assert T.shape == (Xn.shape[1], Xn.shape[0])
            np.testing.assert_allclose(side.fm.as_np(T), Xn.T)


class TestRecycling:
    """R-style vector recycling across a matrix (FM._recycle): direction
    selection, the square-matrix ambiguity, and the error surface."""

    def test_length_ncol_recycles_per_row(self):
        Xn = data(40, 7)
        twins(lambda fm: [fm.conv_R2FM(Xn)
                          - fm.conv_R2FM(np.arange(7, dtype=np.float32)).T],
              lambda m: np.testing.assert_allclose(
                  m, Xn - np.arange(7)[None], rtol=1e-6))

    def test_length_nrow_recycles_per_column(self):
        Xn = data(40, 7)
        twins(lambda fm: [fm.conv_R2FM(Xn)
                          - fm.conv_R2FM(np.arange(40, dtype=np.float32))],
              lambda m: np.testing.assert_allclose(
                  m, Xn - np.arange(40)[:, None], rtol=1e-6))

    def test_square_matrix_prefers_column_major_pairing(self):
        """nrow == ncol pairs vector element i with ROW i (mapply.col)."""
        Xn = data(6, 6)
        v = np.arange(6, dtype=np.float32)
        twins(lambda fm: [fm.conv_R2FM(Xn) + fm.conv_R2FM(v)],
              lambda m: np.testing.assert_allclose(m, Xn + v[:, None],
                                                   rtol=1e-6))

    def test_wrong_length_vector_raises_with_both_options(self):
        Xn = data(40, 7)
        msgs = []
        for side in (REF, PORT):
            X = side.fm.conv_R2FM(Xn)
            bad = side.fm.conv_R2FM(np.ones(13, np.float32))
            with pytest.raises(ValueError) as ei:
                X + bad
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]
        assert "length-13" in msgs[1] and "40" in msgs[1] and "7" in msgs[1]

    def test_matrix_operand_shape_mismatch_raises(self):
        for side in (REF, PORT):
            X = side.fm.conv_R2FM(data(40, 7))
            Y = side.fm.conv_R2FM(data(20, 2))
            with pytest.raises(ValueError, match="shapes must match exactly"):
                X * Y

    def test_virtual_vector_recycles(self):
        """A recycled vector may itself be lazy (e.g. rowMeans output)."""
        Xn = data(50, 4)

        def program(fm):
            X = fm.conv_R2FM(Xn)
            return [X - fm.rowMeans(X)]

        twins(program, lambda m: np.testing.assert_allclose(
            m, Xn - Xn.mean(1, keepdims=True), rtol=1e-5))


class TestSmallTierVocabulary:
    """diag / solve / colMeans / colSds — the small-tier R vocabulary."""

    def test_diag_both_directions(self):
        A = data(5, 5)
        for side in (REF, PORT):
            fm = side.fm
            d = fm.as_np(fm.diag(fm.conv_R2FM(A))).reshape(-1)
            np.testing.assert_allclose(d, np.diag(A))
            D = fm.as_np(fm.diag(np.arange(3, dtype=np.float32)))
            np.testing.assert_allclose(D, np.diag(np.arange(3)))

    def test_solve(self):
        A = data(4, 4) + 10 * np.eye(4, dtype=np.float32)
        b = data(4, 1)
        got = []
        for side in (REF, PORT):
            fm = side.fm
            x = fm.as_np(fm.solve(fm.conv_R2FM(A), fm.conv_R2FM(b)))
            np.testing.assert_allclose(A @ x, b, atol=1e-4)
            Ainv = fm.as_np(fm.solve(fm.conv_R2FM(A)))
            np.testing.assert_allclose(Ainv, np.linalg.inv(A), atol=1e-5)
            got.append((x, Ainv))
        for r, t in zip(*got):
            assert (t.shape, t.dtype) == (r.shape, r.dtype)

    def test_col_moments(self):
        Xn = data(200, 6)

        def program(fm):
            X = fm.conv_R2FM(Xn)
            return [fm.colMeans(X), fm.colSds(X)]

        def check(mu, sd):
            np.testing.assert_allclose(mu.reshape(-1), Xn.mean(0), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(sd.reshape(-1), Xn.std(0, ddof=1),
                                       rtol=1e-3)

        twins(program, check)

    def test_standardize_then_gram_pipeline(self):
        """The README quickstart: standardize lazily, Gram in one pass."""
        Xn = data(300, 5)
        Zn = (Xn - Xn.mean(0)) / Xn.std(0, ddof=1)

        def program(fm):
            X = fm.conv_R2FM(Xn)
            return [fm.crossprod((X - fm.colMeans(X)) / fm.colSds(X))]

        twins(program, lambda g: np.testing.assert_allclose(
            g, Zn.T @ Zn, rtol=1e-3, atol=1e-3))


class TestConvLayout:
    """fm.conv_layout (Table III ``fm.conv.layout``): physical row/col
    majority on the device tier, the same in both packages."""

    @pytest.mark.parametrize("layout", ["row", "col"])
    def test_conv_layout_device_tier(self, layout):
        Xn = data(40, 7)
        for side in (REF, PORT):
            fm = side.fm
            X = fm.conv_R2FM(Xn)
            Y = fm.conv_layout(X, layout)
            assert Y.m.store.layout == layout and Y.shape == X.shape
            assert (Y.m is X.m) == (layout == "row")  # already row-major
            np.testing.assert_array_equal(fm.as_np(Y), Xn)
            np.testing.assert_array_equal(np.asarray(Y.m.block(3, 11)),
                                          Xn[3:11])
            back = fm.conv_layout(Y, "row")
            assert back.m.store.layout == "row"
            np.testing.assert_array_equal(fm.as_np(back), Xn)

        def program(fm):
            Y = fm.conv_layout(fm.conv_R2FM(Xn), layout)
            return [fm.colSums(Y), fm.crossprod(Y), Y * 2.0]

        def check(s, g, y2):
            np.testing.assert_allclose(s.ravel(), Xn.sum(0), rtol=1e-4)
            np.testing.assert_allclose(g, Xn.T @ Xn, rtol=1e-3)
            np.testing.assert_allclose(y2, Xn * 2, rtol=1e-6)

        twins(program, check)

    def test_conv_layout_of_a_transposed_matrix(self):
        """t(X) is a col-layout view of X's buffer; to 'row' it is copied
        into a row-major buffer of Xᵀ."""
        Xn = data(40, 7)
        for side in (REF, PORT):
            fm = side.fm
            T = fm.conv_R2FM(Xn).t()
            assert T.m.store.layout == "col"
            R = fm.conv_layout(T, "row")
            assert R.m.store.layout == "row" and R.shape == (7, 40)
            np.testing.assert_array_equal(fm.as_np(R), Xn.T)

    @pytest.mark.parametrize("layout", ["row", "col"])
    def test_conv_layout_host_tier(self, layout):
        """A host matrix converts on the host tier: a numpy buffer laid
        out as asked, in both packages, and streams out of core."""
        Xn = data(40, 7)
        for side in (REF, PORT):
            fm = side.fm
            X = fm.conv_R2FM(Xn, host=True)
            Y = fm.conv_layout(X, layout)
            assert Y.m.on_host and Y.m.store.layout == layout
            assert isinstance(Y.m.store.data, np.ndarray)
            assert Y.m.store.data.flags.c_contiguous
            np.testing.assert_array_equal(fm.as_np(Y), Xn)
            np.testing.assert_array_equal(np.asarray(Y.m.block(3, 11)),
                                          Xn[3:11])

        def program(fm):
            Y = fm.conv_layout(fm.conv_R2FM(Xn, host=True), layout)
            return [fm.colSums(Y), Y * 2.0]

        def check(s, y2):
            np.testing.assert_allclose(s.ravel(), Xn.sum(0), rtol=1e-4)
            np.testing.assert_allclose(y2, Xn * 2, rtol=1e-6)

        twins(program, check, mode="ooc")

    def test_conv_layout_refusals(self, data_dirs):
        """The port refuses an unknown layout; a disk matrix converts into
        host RAM in the new layout, as in the reference."""
        X = tfm.conv_R2FM(data(8, 3))
        with pytest.raises(ValueError, match="unknown layout"):
            tfm.conv_layout(X, "diagonal")
        a = data(40, 3)
        for f in (jfm, tfm):
            disk = f.load_dense_matrix(a, "lay")
            C = f.conv_layout(disk, "col")
            assert C.m.store.layout == "col" and C.m.on_host
            assert not C.m.on_disk
            np.testing.assert_array_equal(f.as_np(C), a)
            assert f.conv_layout(disk, "row") is not None
        assert tfm.conv_layout(disk, "row").m is disk.m


#: The reference's parametrized tests of TestElementwise, TestAggregation
#: and TestInnerProdGroupBy.
_CELL_TESTS = [
    (TestElementwise, "test_sapply_chain"),
    (TestElementwise, "test_mapply_matrix"),
    (TestElementwise, "test_scalar_forms"),
    (TestElementwise, "test_mapply_row_col"),
    (TestElementwise, "test_pmin_pmax_ifelse0"),
    (TestElementwise, "test_cbind"),
    (TestAggregation, "test_agg_full"),
    (TestAggregation, "test_agg_col_variants"),
    (TestAggregation, "test_agg_row"),
    (TestAggregation, "test_which_min_row_absolute_indices"),
    (TestAggregation, "test_logsumexp_streaming"),
    (TestAggregation, "test_any_all"),
    (TestInnerProdGroupBy, "test_crossprod"),
    (TestInnerProdGroupBy, "test_crossprod_xy"),
    (TestInnerProdGroupBy, "test_tall_matmul"),
    (TestInnerProdGroupBy, "test_semiring_distance"),
    (TestInnerProdGroupBy, "test_groupby_row"),
    (TestInnerProdGroupBy, "test_groupby_col"),
]


@pytest.mark.parametrize("mode,host", [("stream", False), ("whole", True)],
                         ids=["stream-device", "whole-host"])
@pytest.mark.parametrize("cls,name", _CELL_TESTS,
                         ids=[f"{c.__name__}.{n}" for c, n in _CELL_TESTS])
def test_stream_and_host_cells(cls, name, mode, host):
    """The reference's ``("stream", device)`` and ``("whole", host)`` cells:
    the test's program with its sources on that tier, in that mode, held
    to the same oracle with the counters, kernel dispatch and dtypes equal
    (a test the twin runs on both backends runs here on ``cuda``, the
    kernel matchers per partition)."""
    test = getattr(cls(), name)
    kw = ({"backend": "cuda"}
          if "backend" in inspect.signature(test).parameters else {})
    test(mode=mode, host=host, **kw)


def test_port_raises_naming_a7_for_the_stream_and_host_cells(data_dirs):
    """What this file's tiers lacked now runs, equal to the reference's:
    the host-RAM ELL slab (A7a-ii) and the disk tier (A7b) — a physical
    matrix persisted to disk, and a virtual one spilled there."""
    Xn = data()
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 3, 40)
    H = tfm.one_hot(tfm.as_factor(codes, 3), host=True)
    assert H.m.is_sparse and H.m.on_host
    np.testing.assert_array_equal(
        tfm.as_np(H), jfm.as_np(jfm.one_hot(jfm.as_factor(codes, 3),
                                            host=True)))
    for f in (jfm, tfm):
        D = f.persist(f.conv_R2FM(Xn), tier="disk")
        assert D.m.on_disk
        np.testing.assert_array_equal(f.as_np(D), Xn)
        (S,) = f.materialize(f.persist(f.conv_R2FM(Xn) * 2.0, tier="disk"))
        assert S.m.on_disk
        np.testing.assert_allclose(f.as_np(S), Xn * 2.0, rtol=1e-6)
