"""Twin of tests/test_properties.py: the engine's invariants, drawn by
hypothesis, on the port and on the JAX package with the same draws.

  * fusion never changes results (fused == eager), in both packages, and
    the two packages agree;
  * execution mode never changes results (whole == stream == ooc);
  * partition size never changes results (indexed reductions stay
    absolute);
  * groupby.row(sum) ≡ one-hot matmul;
  * dtype promotion is monotone on the lattice and equal to the
    reference's;
  * I/O partition rows are powers of two and equal to the reference's.
"""
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from helpers_twin import PORT, REF, _port_on_cpu  # noqa: F401
from helpers_twin import time_limit  # noqa: F401
from repro.core import dtypes as jdtypes
from repro.core.matrix import io_partition_rows as j_io_rows
from repro_torch.core import dtypes as tdtypes
from repro_torch.core.matrix import io_partition_rows as t_io_rows

pytestmark = pytest.mark.usefixtures("time_limit")

SHAPE = st.tuples(st.integers(5, 200), st.integers(1, 8))


def arrays(draw, shape, dtype=np.float32):
    n, p = shape
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31)))
    return (rng.normal(size=(n, p)) * 2).astype(dtype)


@settings(max_examples=20, deadline=None)
@given(st.data(), SHAPE)
def test_fused_equals_eager(data, shape):
    Xn = arrays(data.draw, shape)
    got = []
    for side in (REF, PORT):
        fm = side.fm
        expr = fm.colSums(fm.abs_(fm.conv_R2FM(Xn) * 2.0 - 1.0))
        (a,) = fm.materialize(expr, fuse=True)
        expr2 = fm.colSums(fm.abs_(fm.conv_R2FM(Xn) * 2.0 - 1.0))
        (b,) = fm.materialize(expr2, fuse=False)
        np.testing.assert_allclose(fm.as_np(a), fm.as_np(b), rtol=1e-4)
        got.append(fm.as_np(a))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-4)


@settings(max_examples=20, deadline=None)
@given(st.data(), SHAPE)
def test_mode_invariance(data, shape):
    """whole == stream == ooc (auto over a host matrix) in each package,
    and the packages agree."""
    Xn = arrays(data.draw, shape)
    got = []
    for side in (REF, PORT):
        fm = side.fm
        ref = None
        for mode, host in (("whole", False), ("stream", False),
                           ("auto", True)):
            X = fm.conv_R2FM(Xn, host=host)
            (g, w) = fm.materialize(fm.crossprod(X), fm.which_min_row(X),
                                    mode=mode)
            if ref is None:
                ref = (fm.as_np(g), fm.as_np(w))
            else:
                np.testing.assert_allclose(fm.as_np(g), ref[0], rtol=1e-3,
                                           atol=1e-3)
                np.testing.assert_array_equal(fm.as_np(w), ref[1])
        got.append(ref)
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got[1][1], got[0][1])


@settings(max_examples=10, deadline=None)
@given(st.data(), st.sampled_from([None, 2048]))
def test_indexed_reduction_partition_invariance(data, budget):
    """which.min over the long dim stays absolute whatever the partition
    count (offset threading), from host RAM: one partition at the default
    budget, many at 2 KiB (prefetched, in both packages)."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31)))
    Xn = rng.normal(size=(500, 3)).astype(np.float32)
    for side in (REF, PORT):
        fm = side.fm
        with fm.conf(io_partition_bytes=budget):
            X = fm.conv_R2FM(Xn, host=True)
            (w,) = fm.materialize(fm.agg_col(X, "which.min"))
        np.testing.assert_array_equal(fm.as_np(w).ravel(), Xn.argmin(0))


@settings(max_examples=15, deadline=None)
@given(st.data(), st.integers(5, 300), st.integers(1, 6), st.integers(1, 5))
def test_groupby_equals_onehot_matmul(data, n, p, k):
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31)))
    Xn = rng.normal(size=(n, p)).astype(np.float32)
    lab = rng.integers(0, k, n).astype(np.int32)
    onehot = np.eye(k, dtype=np.float64)[lab]
    for side in (REF, PORT):
        fm = side.fm
        (g,) = fm.materialize(fm.rowsum(fm.conv_R2FM(Xn), fm.conv_R2FM(lab), k))
        np.testing.assert_allclose(fm.as_np(g), onehot.T @ Xn, rtol=1e-3,
                                   atol=1e-4)


@settings(max_examples=30, deadline=None)
@given(st.sampled_from(["bool", "int8", "int32", "bfloat16", "float32"]),
       st.sampled_from(["bool", "int8", "int32", "bfloat16", "float32"]))
def test_promotion_monotone(a, b):
    p = tdtypes.promote(a, b)
    assert tdtypes.rank(p) >= tdtypes.rank(a)
    assert tdtypes.rank(p) >= tdtypes.rank(b)
    assert tdtypes.promote(a, b) == tdtypes.promote(b, a)
    assert tdtypes.promote(a, a) == tdtypes.canon(a)
    assert tdtypes.name(p) == jdtypes.promote(a, b).name
    assert tdtypes.rank(p) == jdtypes.rank(jdtypes.promote(a, b))


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 4096), st.sampled_from(["float32", "int8", "bfloat16"]),
       st.integers(1, 8))
def test_partition_rows_power_of_two(ncol, dtype, n_live):
    rows = t_io_rows(ncol, dtype, n_live)
    assert rows >= 8
    assert rows & (rows - 1) == 0  # paper: always 2^i
    assert rows == j_io_rows(ncol, dtype, n_live)
