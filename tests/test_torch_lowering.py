"""Twin of tests/test_lowering.py: the port's lowering (plan IR segments,
the ``torch`` and ``cuda`` backends, kernel dispatch, the plan cache's
backend and partition keys) held against the JAX package's.

Where the reference holds its ``pallas`` backend (interpret mode) to its
``xla`` backend, the twin holds the port's ``torch`` and ``cuda`` backends
(the kernel wrappers' plain versions on the CPU) to the reference's
``xla`` outputs within the same tolerance, with equal counters and equal
kernel dispatch (``helpers_twin.both``); the dispatch-only tests compare
the ``pallas`` and ``cuda`` kernel units directly.  The reference's
``stream`` cells (summary chains, Gram, k-means groupby, weighted Gram)
are the ``*_stream`` tests, on the ``cuda`` backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_twin import (PORT, REF, _port_on_cpu, both,  # noqa: F401
                          both_conf, counting)
from repro.core import matrix as jmatrix
from repro_torch.core import lowering as tlowering
from repro_torch.core import matrix as tmatrix

RNG = np.random.default_rng(7)

DTYPES = [np.float32, "bfloat16", np.int32]
BACKENDS = ["torch", "cuda"]


def _tol(dtype):
    if str(dtype) == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-4, atol=1e-5)


def _data(n, p, dtype):
    a = RNG.normal(size=(n, p)) * 3.0
    if dtype != "bfloat16" and np.issubdtype(np.dtype(dtype), np.integer):
        return a.astype(np.int32)
    return a.astype(np.float32)  # bf16 cast happens in conv below


def _fmx(fm, a, dtype):
    """``a`` in ``dtype`` on either side (bf16 built by each framework)."""
    if dtype != "bfloat16":
        return fm.conv_R2FM(a.astype(dtype))
    if fm is REF.fm:
        return fm.conv_R2FM(jnp.asarray(a, jnp.bfloat16))
    return fm.conv_R2FM(torch.as_tensor(a).to(torch.bfloat16))


def _summary_outs(fm, X):
    return [fm.colSums(X), fm.colSums(fm.abs_(X)), fm.colSums(X ** 2),
            fm.colMins(X), fm.colMaxs(X), fm.agg_col(X, "count_nonzero")]


def _close(ref, port, **tol):
    for r, t in zip(ref, port, strict=True):
        np.testing.assert_allclose(t.astype(np.float64),
                                   r.astype(np.float64), **tol)


def _units(side, outs):
    return side.Plan([o.m for o in outs]).program(side.kernel_backend) \
        .kernel_units


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_summary_chain_parity(dtype, backend, mode="whole"):
    """Fused apply→agg.col chains: the port's backend == the reference."""
    a = _data(1000, 5, dtype)
    ref, port = both(lambda fm: _summary_outs(fm, _fmx(fm, a, dtype)),
                     backend=backend, mode=mode)
    _close(ref, port, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_summary_chain_parity_stream(dtype):
    test_summary_chain_parity(dtype, "cuda", mode="stream")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gram_parity(dtype, backend, mode="whole"):
    a = _data(800, 6, np.float32)
    ref, port = both(lambda fm: [fm.crossprod(_fmx(fm, a, dtype))],
                     backend=backend, mode=mode)
    _close(ref, port, **_tol(dtype))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gram_parity_stream(dtype):
    test_gram_parity(dtype, "cuda", mode="stream")


@pytest.mark.parametrize("backend", BACKENDS)
def test_xty_parity(backend):
    a = _data(600, 5, np.float32)
    b = _data(600, 3, np.float32)
    ref, port = both(lambda fm: [fm.crossprod(fm.conv_R2FM(a),
                                              fm.conv_R2FM(b))],
                     backend=backend)
    _close(ref, port, rtol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmeans_groupby_parity(backend, mode="whole"):
    """The Lloyd pattern (distances → which.min → groupby sums/counts +
    objective) through both packages."""
    rng = np.random.default_rng(0)
    true_c = rng.normal(size=(4, 6)) * 10          # well-separated clusters
    a = np.concatenate(
        [c + rng.normal(size=(300, 6)) for c in true_c]).astype(np.float32)
    centers = (true_c + rng.normal(size=true_c.shape)).astype(np.float32)

    def lloyd(fm):
        X = fm.conv_R2FM(a)
        D = fm.inner_prod(X, centers.T, "squared_diff", "sum")
        labels = fm.which_min_row(D)
        return [fm.rowsum(X, labels, 4), fm.table_(labels, 4),
                fm.sum_(fm.rowMins(D)), labels]

    (sx, cx, wx, lx), (sp, cp, wp, lp) = both(lloyd, backend=backend,
                                              mode=mode)
    np.testing.assert_array_equal(lp, lx)
    np.testing.assert_array_equal(cp, cx)
    np.testing.assert_allclose(sp, sx, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(wp, wx, rtol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_weighted_gram_parity(backend, mode="whole"):
    """crossprod(X*w, X) (the IRLS step's XᵀWX): the port == the reference
    and numpy."""
    a = _data(900, 5, np.float32)
    wv = np.abs(RNG.normal(size=(900,))).astype(np.float32)

    def build(fm):
        X = fm.conv_R2FM(a)
        return [fm.crossprod(fm.mapply_col(X, fm.conv_R2FM(wv), "mul"), X)]

    (gx,), (gp,) = both(build, backend=backend, mode=mode)
    expected = (a * wv[:, None]).T.astype(np.float64) @ a
    np.testing.assert_allclose(gp, gx, rtol=1e-4)
    for g in (gx, gp):
        np.testing.assert_allclose(g, expected, rtol=1e-3)


def test_kmeans_groupby_parity_stream():
    test_kmeans_groupby_parity("cuda", mode="stream")


def test_weighted_gram_parity_stream():
    test_weighted_gram_parity("cuda", mode="stream")


_BF16_PROGRAMS = {
    "div": lambda fm, X: [X / 2],
    "sqrt": lambda fm, X: [fm.sqrt(fm.abs_(X))],
    "exp": lambda fm, X: [fm.exp(X)],
    "logsumexp": lambda fm, X: [fm.agg_row(X, "logsumexp")],
    "summary": lambda fm, X: _summary_outs(fm, X),
    "gram": lambda fm, X: [fm.crossprod(X)],
    "moments": lambda fm, X: [fm.colMeans(X), fm.colSds(X)],
    # C6: a float op declares float32 but computes its block in bf16; the
    # matmul against an f32 small matrix promotes as jnp.matmul does.
    "div_matmul": lambda fm, X: [(X / 2) @ _C6_B],
    "sqrt_matmul": lambda fm, X: [fm.sqrt(fm.abs_(X)) @ _C6_B],
}

_C6_B = np.random.default_rng(6).normal(size=(4, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_BF16_PROGRAMS))
def test_bf16_promotes_and_dispatches_as_the_reference(name):
    """bf16 is not ``is_floating`` in the reference (numpy's kind of
    ml_dtypes' bfloat16 is 'V'): a float-valued op on it promotes to
    float32 and no kernel claims a bf16 operand.  The port follows
    (ROADMAP §C, C4): equal output dtypes and kernel units, values within
    the reference's bf16 tolerance."""
    a = _data(300, 4, np.float32)
    ref, port = both(lambda fm: _BF16_PROGRAMS[name](
        fm, _fmx(fm, a, "bfloat16")), backend="cuda")
    if name.endswith("_matmul"):
        # A sum of bf16 values cancels, and the reference's sum departs
        # from the float64 product of the same bf16 values by more than
        # rtol/atol allow on a cancelled entry: held as the fuzz harness
        # holds values, normalized by the output's scale.
        for r, t in zip(ref, port, strict=True):
            scale = max(1.0, float(np.abs(r).max()))
            assert np.abs(t.astype(np.float64) - r).max() / scale <= 2e-2
    else:
        _close(ref, port, **_tol("bfloat16"))


def test_weighted_gram_dispatch_both_orientations():
    """Both crossprod(Xw, X) and crossprod(X, Xw) lower onto wgram."""
    a = _data(256, 4, np.float32)
    wv = np.abs(RNG.normal(size=(256,))).astype(np.float32)
    for side in (REF, PORT):
        fm = side.fm
        X, w = fm.conv_R2FM(a), fm.conv_R2FM(wv)
        for build in (lambda: fm.crossprod(fm.mapply_col(X, w, "mul"), X),
                      lambda: fm.crossprod(X, fm.mapply_col(X, w, "mul"))):
            assert [u.kernel for u in _units(side, [build()])] == ["wgram"]


def test_weighted_gram_not_matched_for_distinct_matrices():
    """Weights on a DIFFERENT matrix than the contraction partner is
    XᵀW Y, not XᵀWX: wgram must not claim it, and the result is right."""
    a = _data(128, 3, np.float32)
    b = _data(128, 4, np.float32)
    wv = np.abs(RNG.normal(size=(128,))).astype(np.float32)

    def program(fm):
        X, Y, w = fm.conv_R2FM(a), fm.conv_R2FM(b), fm.conv_R2FM(wv)
        return [fm.crossprod(fm.mapply_col(X, w, "mul"), Y)]

    for side in (REF, PORT):
        assert all(u.kernel != "wgram"
                   for u in _units(side, program(side.fm)))
    for (g,) in both(program, backend="cuda"):
        np.testing.assert_allclose(g, (a * wv[:, None]).T @ b, rtol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_int_dtype_parity(backend):
    """Integer apply→agg chains accumulate in i32: both packages agree
    EXACTLY."""
    a = RNG.integers(-50, 50, size=(500, 4)).astype(np.int32)

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.colSums(X), fm.colMaxs(X)]

    ref, port = both(program, backend=backend)
    for r, t in zip(ref, port):
        np.testing.assert_array_equal(t, r)


def test_int_chains_dispatch_to_fused_apply_agg():
    """int sources dispatch to the chain kernel with an i32 accumulator and
    stay exact where a float32 one would round (values past 2²⁴)."""
    a = np.zeros((64, 2), np.int32)
    a[0] = (1 << 24) + 1          # not representable in float32
    a[1:] = 1

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.colSums(X), fm.colMaxs(X), fm.colMins(X)]

    for side in (REF, PORT):
        units = _units(side, program(side.fm))
        assert [u.kernel for u in units] == ["fused_apply_agg"]
        assert sorted(c[2] for c in units[0].chains) == ["int32"] * 3
    for s, mx, mn in both(program, backend="cuda"):
        np.testing.assert_array_equal(s.reshape(-1), a.sum(0))  # exact
        np.testing.assert_array_equal(mx.reshape(-1), a.max(0))
        np.testing.assert_array_equal(mn.reshape(-1), a.min(0))


def test_cast_chains_dispatch_to_fused_apply_agg():
    """Chains containing lazy cast nodes stay in the kernel."""
    a = RNG.integers(0, 100, size=(300, 3)).astype(np.int32)

    def program(fm):
        Xf = fm.sapply(fm.conv_R2FM(a), "cast_float32")
        return [fm.colSums(Xf), fm.colSums(Xf ** 2)]

    for side in (REF, PORT):
        units = _units(side, program(side.fm))
        assert [u.kernel for u in units] == ["fused_apply_agg"]
        assert len(units[0].chains) == 2
    for s, s2 in both(program, backend="cuda"):
        np.testing.assert_allclose(s.reshape(-1), a.sum(0), rtol=1e-6)
        np.testing.assert_allclose(s2.reshape(-1),
                                   (a.astype(np.float64) ** 2).sum(0),
                                   rtol=1e-5)


def test_mixed_acc_dtypes_share_one_kernel_call():
    """float stats and exact integer counts over one source fuse into ONE
    kernel read (per-chain accumulator dtypes)."""
    a = _data(400, 3, np.float32)

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.colSums(X), fm.agg_col(X, "count_nonzero")]

    for side in (REF, PORT):
        units = _units(side, program(side.fm))
        assert len(units) == 1
        assert sorted(c[2] for c in units[0].chains) == ["float32", "int32"]
    for s, c in both(program, backend="cuda"):
        np.testing.assert_allclose(s.reshape(-1), a.sum(0), rtol=1e-4)
        np.testing.assert_array_equal(c.reshape(-1), (a != 0).sum(0))


def test_engine_dispatches_to_kernels():
    a = _data(512, 4, np.float32)
    for side, generic in ((REF, "xla"), (PORT, "torch")):
        fm = side.fm
        X = fm.conv_R2FM(a)
        plan = side.Plan([fm.crossprod(X).m, fm.colSums(fm.abs_(X)).m])
        kernels = sorted(u.kernel for u in
                         plan.program(side.kernel_backend).kernel_units)
        assert kernels == ["fused_apply_agg", "gram"]
        # the generic lowering of the same plan has no kernel units
        assert plan.program(generic).kernel_units == []


def test_apply_agg_chains_share_one_source_read():
    """N agg.col chains over one matrix fuse into ONE kernel call."""
    a = _data(512, 4, np.float32)
    for side in (REF, PORT):
        units = _units(side, _summary_outs(side.fm, side.fm.conv_R2FM(a)))
        assert len(units) == 1 and len(units[0].chains) == 6


def test_kmeans_pattern_single_kernel():
    a = _data(512, 4, np.float32)
    centers = RNG.normal(size=(3, 4)).astype(np.float32)
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        D = fm.inner_prod(X, centers.T, "squared_diff", "sum")
        labels = fm.which_min_row(D)
        units = _units(side, [fm.rowsum(X, labels, 3), fm.table_(labels, 3),
                              fm.sum_(fm.rowMins(D)), labels])
        assert [u.kernel for u in units] == ["kmeans_assign"]


# ---------------------------------------------------------------------------
# Plan cache: backend + both partition levels in the key
# ---------------------------------------------------------------------------

_CACHE = ("plan_cache_hits", "plan_cache_misses", "materialize_calls")


def test_plan_cache_misses_on_backend_change():
    a = _data(4096, 4, np.float32)
    got = []
    for side, (generic, kernel) in ((REF, ("xla", "pallas")),
                                    (PORT, ("torch", "cuda"))):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with counting(side, _CACHE) as act:
            fm.materialize(fm.colSums(X), backend=generic)
            fm.materialize(fm.colSums(X), backend=kernel)
            fm.materialize(fm.colSums(X), backend=kernel)
        # backend is part of the key; the second kernel run is a hit
        assert act == {"plan_cache_hits": 1, "plan_cache_misses": 2,
                       "materialize_calls": 3}
        got.append(len(side.mz._PLANS))
    assert got == [2, 2]


def test_plan_cache_misses_on_vmem_budget_change():
    """Retuning the processor-level budget must retrace, not reuse."""
    a = _data(8192, 4, np.float32)
    old = (jmatrix.VMEM_PARTITION_BYTES, tmatrix.VMEM_PARTITION_BYTES)
    try:
        for side in (REF, PORT):
            fm = side.fm
            X = fm.conv_R2FM(a)
            fm.materialize(fm.colSums(X), backend=side.kernel_backend)
            assert len(side.mz._PLANS) == 1
        with both_conf(vmem_partition_bytes=64 * 1024):
            for side in (REF, PORT):
                fm = side.fm
                (s,) = fm.materialize(fm.colSums(fm.conv_R2FM(a)),
                                      backend=side.kernel_backend)
                assert len(side.mz._PLANS) == 2
                np.testing.assert_allclose(fm.as_np(s).reshape(-1),
                                           a.sum(0), rtol=1e-4)
    finally:
        jmatrix.VMEM_PARTITION_BYTES, tmatrix.VMEM_PARTITION_BYTES = old


def test_compile_once_stream_many_per_backend():
    """k-means-style iteration: new centers reuse one cached plan per
    backend — the compile-once/stream-many contract."""
    a = _data(2048, 4, np.float32)
    centers = [RNG.normal(size=(3, 4)).astype(np.float32) for _ in range(3)]
    acts = []
    for side, backends in ((REF, ("xla", "pallas")),
                           (PORT, ("torch", "cuda"))):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with counting(side, _CACHE + ("passes", "partition_steps")) as act:
            for backend in backends:
                for c in centers:
                    D = fm.inner_prod(X, c.T, "squared_diff", "sum")
                    labels = fm.which_min_row(D)
                    fm.materialize(fm.rowsum(X, labels, 3),
                                   fm.table_(labels, 3),
                                   fm.sum_(fm.rowMins(D)), labels,
                                   backend=backend)
        # one entry per backend, not per iteration
        assert (act["plan_cache_misses"], act["plan_cache_hits"]) == (2, 4)
        assert len(side.mz._PLANS) == 2
        acts.append(act)
    assert acts[1] == acts[0]


def test_resolve_backend():
    for name in ("torch", "cuda"):
        assert tlowering.resolve_backend(name) == name
    assert tlowering.resolve_backend("auto") in ("torch", "cuda")
    with pytest.raises(ValueError):
        tlowering.resolve_backend("tpu2000")


def test_set_conf_backend_roundtrip():
    """The backend knob sets the default: a materialize without a backend
    runs ``cuda``, so the same program asked for ``cuda`` by name hits the
    plan it cached."""
    fm = PORT.fm
    a = _data(256, 3, np.float32)
    X = fm.conv_R2FM(a)
    conf = fm.set_conf(backend="cuda")
    try:
        assert conf["backend"] == "cuda"
        with counting(PORT, _CACHE) as act:
            (s,) = fm.materialize(fm.colSums(X))  # default now cuda
            fm.materialize(fm.colSums(X), backend="cuda")
        assert act == {"plan_cache_hits": 1, "plan_cache_misses": 1,
                       "materialize_calls": 2}
        np.testing.assert_allclose(fm.as_np(s).reshape(-1), a.sum(0),
                                   rtol=1e-4)
    finally:
        fm.set_conf(backend="auto")


#: The reference's dispatch words → the port's.
_DISPATCH_NAME_MAP = (("xla generic trace", "torch generic rules"),
                      ("pallas:", "cuda:"),
                      ("generic trace (", "generic rules ("),
                      ("on the XLA path", "on the torch path"))


def test_dispatch_report_words_are_the_reference_s(monkeypatch):
    """``dispatch_report``'s text is the reference's under the name map, on
    both backends, for a claimed segment, an unmatched one and a 64-bit one
    (the engine canonicalizes 64-bit sources to 32 bits, so the segment is
    retyped by hand, with x64 on in the reference)."""
    from repro.core import dtypes as jdtypes
    from repro.core import lowering as jlowering
    monkeypatch.setattr(jdtypes, "_x64", lambda: True)
    a = _data(64, 3, np.float32)
    got = {}
    for side, low, f64, backends in (
            (REF, jlowering, jnp.float64, ("xla", "pallas")),
            (PORT, tlowering, torch.float64, ("torch", "cuda"))):
        fm = side.fm
        X = fm.conv_R2FM(a)
        ps = side.Plan([fm.rowSums(X).m, fm.crossprod(X).m]).passes[0]
        reports = [low.dispatch_report(ps, ps.ir, be) for be in backends]
        seg = next(s for s in ps.ir.segments if s.kind == "row_local")
        seg.dtype = f64
        reports.append(low.dispatch_report(ps, ps.ir, backends[1]))
        got[side.name] = [sorted(r.items()) for r in reports]
    want = [[(sid, _mapped(text)) for sid, text in r]
            for r in got[REF.name]]
    assert got[PORT.name] == want
    assert ("generic rules (64-bit dtype: kernels keep full precision on "
            "the torch path)") in dict(got[PORT.name][2]).values()


def _mapped(text: str) -> str:
    for old, new in _DISPATCH_NAME_MAP:
        text = text.replace(old, new)
    return text
