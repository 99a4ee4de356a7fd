"""Twin of tests/test_batch.py: ``fm.batch`` in the port against the JAX
package.

Every test of the reference file runs here with its parametrizations, the
port on ``torch`` or ``cuda`` (the ``cuda`` backend's kernel wrappers take
their plain versions on CPU tensors) where the reference runs ``xla`` or
``pallas``.  The batch calls go through ``helpers_twin.both_batched``: the
same requests over the same numpy inputs in both packages, with the plan
counters (``helpers_twin.COUNTERS``: streams, passes, partition steps,
bytes, reuse hits), each request's dispatched kernels and the outputs'
shapes and dtypes equal exactly; the values are then held to the
reference test's oracle and tolerance on both sides.  Tests that drive
something other than one batch call (serial runs, collector handles,
scopes, faults, iteration scopes, traces) run the reference's body in each
package and compare what it counts.

One case is the port's own: two identical requests in one batch borrow one
cached template, and each gets its own result (no request overwrites the
other's).
"""
from importlib import import_module

import numpy as np
import pytest

from helpers_cache import assert_no_partial_results
from helpers_twin import (PORT, REF, _port_on_cpu, both_batched,  # noqa: F401
                          both_conf, counting, data_dirs, flaky_matrix,
                          save_both, time_limit)

pytestmark = pytest.mark.usefixtures("time_limit")

SIDES = [REF, PORT]

CELLS = [(backend, mode)
         for backend in ("torch", "cuda")
         for mode in ("whole", "stream", "ooc")]

def _x(n=600, p=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)) * 2 + 0.5).astype(np.float32)


@pytest.fixture(autouse=True)
def _small_partitions():
    """Multi-partition streams, fresh plan caches per test."""
    with both_conf(io_partition_bytes=4096):
        REF.mz.clear_plan_cache()
        PORT.mz.clear_plan_cache()
        yield
    REF.mz.clear_plan_cache()
    PORT.mz.clear_plan_cache()


def _be(side, backend):
    """The side's backend: the port's, or the reference's ``xla``."""
    return backend if side is PORT else "xla"


def _requests_over(fm, X):
    """Three independent requests sharing one source: the doc example."""
    return [fm.colMeans(X), (fm.colSds(X), fm.crossprod(X)), fm.sum_(X)]


def _check_oracle(a, res):
    """The reference test's oracle, on a batch's numpy results."""
    np.testing.assert_allclose(res[0].ravel(), a.mean(0), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(res[1][0].ravel(), a.std(0, ddof=1),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res[1][1], a.T.astype(np.float64) @ a,
                               rtol=2e-3)
    np.testing.assert_allclose(float(res[2].reshape(())), a.sum(),
                               rtol=1e-3)


def _stats(side):
    return {k: v for k, v in side.mz.exec_stats().items()
            if k in ("streams", "passes", "partition_steps",
                     "prefetch_reuse_hits", "pass_bytes_in",
                     "materialize_calls", "plan_cache_hits")}


# ---------------------------------------------------------------------------
# The tentpole: parity + 1 stream × k plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,mode", CELLS)
def test_batched_equals_serial(backend, mode):
    a = _x(seed=1)

    def program(fm):
        return _requests_over(fm, fm.conv_R2FM(a, host=(mode == "ooc")))

    ref, port = both_batched(program, backend=backend, mode=mode)
    for res in (ref, port):
        _check_oracle(a, res)
    # The serial runs of each package, over a copy of the same source.  The
    # group streams at the smallest member's partition rows, so a partial
    # combine order can differ from a solo run by float32 rounding.
    for side, res in ((REF, ref), (PORT, port)):
        fm, be = side.fm, _be(side, backend)
        X = fm.conv_R2FM(a, host=(mode == "ooc"))
        serial = [fm.materialize(fm.colMeans(X), mode=mode, backend=be)[0],
                  fm.materialize(fm.colSds(X), fm.crossprod(X), mode=mode,
                                 backend=be),
                  fm.materialize(fm.sum_(X), mode=mode, backend=be)[0]]
        np.testing.assert_allclose(res[0], fm.as_np(serial[0]), rtol=1e-6)
        np.testing.assert_allclose(res[1][1], fm.as_np(serial[1][1]),
                                   rtol=1e-6)
        np.testing.assert_allclose(res[2], fm.as_np(serial[2]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["stream", "ooc"])
def test_one_stream_k_plans(mode):
    a = _x(1200, 6, seed=2)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=(mode == "ooc"))
        side.mz.reset_exec_stats()
        res = fm.batch(*_requests_over(fm, X), mode=mode)
        st = side.mz.exec_stats()
        # Three plans, one physical sweep: union bytes == one pass over X.
        assert st["streams"] == 1
        assert st["passes"] == 3
        assert st["pass_bytes_in"] == (X.m.nbytes(),)
        _check_oracle(a, [fm.as_np(res[0]), [fm.as_np(v) for v in res[1]],
                          fm.as_np(res[2])])
        got[side.name] = _stats(side)
    assert got[PORT.name] == got[REF.name]


def test_serial_streams_kx():
    """The counter-provable win: the same requests serially stream k×."""
    a = _x(1200, 6, seed=3)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        side.mz.reset_exec_stats()
        for req in _requests_over(fm, X):
            outs = req if isinstance(req, tuple) else (req,)
            fm.materialize(*outs, mode="ooc")
        st = side.mz.exec_stats()
        assert st["streams"] == 3 and st["passes"] == 3
        got[side.name] = _stats(side)
    assert got[PORT.name] == got[REF.name]


def test_batch_disk_tier_single_scan(data_dirs):
    """k plans over one shared disk matrix = one scan of the file."""
    a = _x(2000, 4, seed=3)
    save_both(a, "batch_x")

    def program(fm):
        X = fm.get_dense_matrix("batch_x")
        assert X.m.on_disk
        return _requests_over(fm, X)

    for side in SIDES:
        side.mz.reset_exec_stats()
    ref, port = both_batched(program)
    for side, res in ((REF, ref), (PORT, port)):
        st = side.mz.exec_stats()
        nbytes = side.fm.get_dense_matrix("batch_x").m.nbytes()
        assert st["streams"] == 1 and st["passes"] == 3
        assert st["pass_bytes_in"] == (nbytes,)
        _check_oracle(a, res)


def test_subset_source_set_rides_superset_stream():
    """A plan over {X} joins the stream of a plan over {X, Y}."""
    a, b = _x(900, 3, seed=4), _x(900, 3, seed=5)

    def program(fm):
        X = fm.conv_R2FM(a, host=True)
        Y = fm.conv_R2FM(b, host=True)
        return [fm.sum_(X * Y), fm.colMeans(X)]

    for side in SIDES:
        side.mz.reset_exec_stats()
    ref, port = both_batched(program)
    for side in SIDES:
        st = side.mz.exec_stats()
        assert st["streams"] == 1 and st["passes"] == 2
    for s_m, m_m in (ref, port):
        np.testing.assert_allclose(float(s_m.reshape(())), (a * b).sum(),
                                   rtol=1e-3)
        np.testing.assert_allclose(m_m.ravel(), a.mean(0), rtol=1e-4,
                                   atol=1e-4)


def test_disjoint_sources_stream_separately():
    a, b = _x(900, 3, seed=6), _x(900, 3, seed=7)

    def program(fm):
        return [fm.colMeans(fm.conv_R2FM(a, host=True)),
                fm.colMeans(fm.conv_R2FM(b, host=True))]

    for side in SIDES:
        side.mz.reset_exec_stats()
    ref, port = both_batched(program)
    for side in SIDES:
        st = side.mz.exec_stats()
        assert st["streams"] == 2 and st["passes"] == 2
    for mx, my in (ref, port):
        np.testing.assert_allclose(mx.ravel(), a.mean(0), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(my.ravel(), b.mean(0), rtol=1e-4,
                                   atol=1e-4)


def test_multipass_member_batches_round_zero():
    """scale(X) (two passes) batched with colMeans(X) (one pass): round 0
    groups both pass-0s onto one stream, round 1 runs scale's sweep."""
    a = _x(800, 4, seed=8)

    def program(fm):
        X = fm.conv_R2FM(a, host=True)
        return [fm.scale(X), fm.colMeans(X)]

    for side in SIDES:
        side.mz.reset_exec_stats()
    ref, port = both_batched(program)
    for side in SIDES:
        st = side.mz.exec_stats()
        assert st["passes"] == 3          # scale's two + colMeans' one
        assert st["streams"] == 2         # round 0 shared, round 1 solo
    want = (a - a.mean(0)) / a.std(0, ddof=1)
    for z_m, mu_m in (ref, port):
        np.testing.assert_allclose(z_m, want, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(mu_m.ravel(), a.mean(0), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_collector_form_and_handles(side):
    fm = side.fm
    a = _x(500, 3, seed=9)
    X = fm.conv_R2FM(a)
    with fm.batch() as b:
        h1 = b.add(fm.colMeans(X).m)
        h2 = b.add(fm.colSds(X).m, fm.crossprod(X).m)
    np.testing.assert_allclose(fm.as_np(h1.value).ravel(), a.mean(0),
                               rtol=1e-4, atol=1e-4)
    sds, ctp = h2.value
    np.testing.assert_allclose(fm.as_np(sds).ravel(), a.std(0, ddof=1),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(fm.as_np(ctp), a.T.astype(np.float64) @ a,
                               rtol=2e-3)
    with pytest.raises(RuntimeError, match="already executed"):
        b.add(fm.colMeans(X).m)
    with pytest.raises(RuntimeError, match="already executed"):
        b.run()


# ---------------------------------------------------------------------------
# Attribution: per-request scopes see their own share
# ---------------------------------------------------------------------------

def test_per_request_scope_attribution():
    a = _x(1500, 4, seed=10)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        side.mz.reset_exec_stats()
        b = fm.batch()
        with fm.collect_stats("req0") as sc0:
            h0 = b.add(fm.colMeans(X).m)
        with fm.collect_stats("req1") as sc1:
            h1 = b.add(fm.colSds(X).m, fm.crossprod(X).m)
        b.run()
        scoped = []
        for sc in (sc0, sc1):
            s = sc.stats()
            # Each request's scope reports its plan: one pass, one stream,
            # its own bytes — not the group totals.
            assert s["passes"] == 1
            assert s["streams"] == 1
            assert s["bytes_streamed"] == X.m.nbytes()
            assert s["pass_bytes_in"] == (X.m.nbytes(),)
            assert s["partition_steps"] >= 1
            scoped.append({k: s[k] for k in (
                "passes", "streams", "bytes_streamed", "pass_bytes_in",
                "partition_steps", "materialize_calls")})
        # The root scope saw the group: 2 logical passes, 1 physical stream.
        st = side.mz.exec_stats()
        assert st["passes"] == 2 and st["streams"] == 1
        assert float(fm.as_np(h0.value).ravel()[0]) == \
            pytest.approx(a.mean(0)[0], rel=1e-4)
        assert h1.value is not None
        got[side.name] = (scoped, _stats(side))
    assert got[PORT.name] == got[REF.name]


# ---------------------------------------------------------------------------
# Fault injection: no partial sinks for any member
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [False, True])
def test_interrupted_group_leaves_no_member_partial(prefetch):
    a = _x(800, 4, seed=11)
    for side in SIDES:
        fm = side.fm
        Xm, store = flaky_matrix(side, a, 1)
        X = fm.FM(Xm)
        reqs = [fm.colMeans(X), fm.crossprod(X)]
        toposort = import_module(f"{side.name}.core.dag").toposort
        nodes = [n for r in reqs for n in toposort([r.m.node])]
        with pytest.raises(Exception, match="staging failure"):
            fm.batch(*reqs, prefetch=prefetch)
        assert store.failed
        # No member of the interrupted group registered anything.
        assert_no_partial_results(*nodes)
        store.heal()
        mu_m, ctp_m = fm.batch(*reqs, prefetch=prefetch)
        np.testing.assert_allclose(fm.as_np(mu_m).ravel(), a.mean(0),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fm.as_np(ctp_m),
                                   a.T.astype(np.float64) @ a, rtol=2e-3)


# ---------------------------------------------------------------------------
# Partition reuse: resident final partition served instead of re-read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [False, True])
def test_intra_plan_partition_reuse(prefetch):
    """PCA's shape — crossprod(X - colMeans(X)): the pass-2 contraction
    streams X under the same partition schedule as the pass-1 moments, so
    the final partition is not re-staged."""
    a = _x(1000, 4, seed=12)
    c = a - a.mean(0)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        C = fm.crossprod(X - fm.colMeans(X))
        plan = side.Plan([C.m])
        assert plan.n_passes == 2
        assert plan.passes[0].partition_rows == plan.passes[1].partition_rows
        with counting(side) as cnt:
            (cm,) = fm.materialize(C, mode="ooc", prefetch=prefetch)
        assert cnt["prefetch_reuse_hits"] == 1
        np.testing.assert_allclose(fm.as_np(cm), c.T.astype(np.float64) @ c,
                                   rtol=2e-3)
        got[side.name] = cnt
    assert got[PORT.name] == got[REF.name]


def test_iteration_scope_reuse_across_materializes():
    """Inside fm.inspect_iterations(), iteration i+1's stream starts from
    iteration i's resident final partition; outside, residency is dropped."""
    a = _x(1000, 4, seed=13)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        side.mz.reset_exec_stats()
        with fm.inspect_iterations():
            for _ in range(3):
                fm.materialize(fm.colMeans(X), mode="ooc", reuse_plans=False)
        st = _stats(side)
        assert st["prefetch_reuse_hits"] == 2    # iterations 2 and 3
        # Residency must not outlive the scope.
        side.mz.reset_exec_stats()
        fm.materialize(fm.colSds(X), mode="ooc")
        assert side.mz.exec_stats()["prefetch_reuse_hits"] == 0
        got[side.name] = st
    assert got[PORT.name] == got[REF.name]


def test_iteration_scope_reuse_across_batches():
    a = _x(1000, 4, seed=14)
    got = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        side.mz.reset_exec_stats()
        with fm.inspect_iterations():
            fm.batch(fm.colMeans(X), fm.sum_(X))
            fm.batch(fm.colMeans(X * 2.0), fm.sum_(X * 0.5))
        st = _stats(side)
        assert st["streams"] == 2 and st["passes"] == 4
        assert st["prefetch_reuse_hits"] == 1
        got[side.name] = st
    assert got[PORT.name] == got[REF.name]


# ---------------------------------------------------------------------------
# Co-schedule unit behavior + explain view
# ---------------------------------------------------------------------------

def test_coschedule_groups_by_subset():
    from repro.core.fusion import coschedule as jcoschedule
    from repro_torch.core.fusion import coschedule
    x, y, z = object(), object(), object()
    keys = [(100, frozenset({id(x)})),
            (100, frozenset({id(x), id(y)})),
            (100, frozenset({id(z)})),
            (200, frozenset({id(x)})),
            (100, frozenset())]
    groups = coschedule(keys)
    assert groups == jcoschedule(keys)
    assert sorted(map(sorted, groups)) == [[0, 1], [2], [3], [4]]


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_stream_group_key_is_physical_identity(side):
    stream_group_key = import_module(
        f"{side.name}.core.fusion").stream_group_key
    fm = side.fm
    a = _x(300, 3, seed=15)
    X = fm.conv_R2FM(a, host=True)
    k1 = stream_group_key(side.Plan([fm.colMeans(X).m]).passes[0])
    k2 = stream_group_key(side.Plan([fm.colSds(X).m]).passes[0])
    assert k1 == k2
    k3 = stream_group_key(side.Plan(
        [fm.colMeans(fm.conv_R2FM(a, host=True)).m]).passes[0])
    assert k3 != k1


def test_plan_staged_sources_and_result_nodes():
    """``Plan.staged_sources`` (one pair a physical matrix across every
    pass) and ``Plan.result_nodes`` (the result slots in pass order) of a
    two-pass plan over two matrices, as the reference's."""
    a, b = _x(300, 3, seed=20), _x(300, 3, seed=21)
    got = {}
    for side in SIDES:
        fm = side.fm
        X, Y = fm.conv_R2FM(a, host=True), fm.conv_R2FM(b, host=True)
        plan = side.Plan([fm.scale(X).m, fm.colMeans(Y).m,
                          fm.crossprod(X, Y).m])
        pairs = plan.staged_sources()
        assert [id(m) for _, m in pairs] == [id(X.m), id(Y.m)]
        got[side.name] = (plan.n_passes, [m.shape for _, m in pairs],
                          [(n.kind, n.shape) for n in plan.result_nodes()])
    assert got[PORT.name] == got[REF.name]


def test_group_program_composes_members():
    """``lowering.GroupProgram`` over a group's (pass, program) pairs: the
    members' kernel units in order, the smallest member's partition rows,
    and its description, as the reference's."""
    a, b = _x(2000, 6, seed=22), _x(2000, 1, seed=23)
    got = {}
    for side, be in ((REF, "pallas"), (PORT, "cuda")):
        fm = side.fm
        lowering = import_module(f"{side.name}.core.lowering")
        X, Y = fm.conv_R2FM(a, host=True), fm.conv_R2FM(b, host=True)
        members = []
        for out in (fm.colMeans(X), fm.crossprod(X), fm.crossprod(X, Y)):
            plan = side.Plan([out.m])
            members.append((plan.passes[0], plan.program(be)))
        g = lowering.GroupProgram(members)
        assert g.partition_rows == min(ps.partition_rows for ps, _ in members)
        got[side.name] = ([u.kernel for u in g.kernel_units],
                          g.partition_rows,
                          [ps.partition_rows for ps, _ in members],
                          g.describe().splitlines()[0])
    assert got[PORT.name] == got[REF.name]


def test_explain_batch_group_view():
    a = _x(400, 3, seed=16)
    texts = {}
    for side in SIDES:
        fm = side.fm
        X = fm.conv_R2FM(a, host=True)
        out = fm.explain_batch(fm.colMeans(X),
                               (fm.colSds(X), fm.crossprod(X)))
        assert "members=2" in out
        assert "once" in out and "serially" in out
        # Nothing executed, nothing registered.
        assert fm.colMeans(X).is_virtual
        texts[side.name] = out
    assert texts[PORT.name] == texts[REF.name]


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_batch_trace_has_stream_spans(side):
    fm = side.fm
    a = _x(600, 3, seed=17)
    X = fm.conv_R2FM(a, host=True)
    with fm.trace():
        fm.batch(fm.colMeans(X), fm.crossprod(X))
    names = [e["name"] for e in fm.trace_events()]
    assert "batch" in names
    assert names.count("stream") == 1


# ---------------------------------------------------------------------------
# A borrowed cached template: two identical requests in one batch
# ---------------------------------------------------------------------------

def test_identical_requests_borrow_one_template():
    """Two structurally identical requests in one batch share one cached
    plan template (the second is a plan-cache hit) and ride one stream;
    each gets its own result, registered on its own nodes — and a third
    over another source, also borrowing the template, is not written over
    by either."""
    a, b = _x(700, 4, seed=18), _x(700, 4, seed=19)

    def program(fm):
        X = fm.conv_R2FM(a, host=True)
        Y = fm.conv_R2FM(b, host=True)
        return [(fm.colMeans(X), fm.crossprod(X)),
                (fm.colMeans(X), fm.crossprod(X)),
                (fm.colMeans(Y), fm.crossprod(Y))]

    for side in SIDES:
        side.mz.reset_exec_stats()
    ref, port = both_batched(program)
    for side, res in ((REF, ref), (PORT, port)):
        st = side.mz.exec_stats()
        assert st["plan_cache_hits"] == 2 and st["plan_cache_misses"] == 1
        assert st["streams"] == 2 and st["passes"] == 3
        for (mu, g), arr in zip(res, (a, a, b)):
            np.testing.assert_allclose(mu.ravel(), arr.mean(0), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(g, arr.T.astype(np.float64) @ arr,
                                       rtol=2e-3)
        np.testing.assert_array_equal(res[0][0], res[1][0])
    # Each request's outputs are its own registered stores.
    fm = PORT.fm
    reqs = program(fm)
    out = fm.batch(*reqs)
    stores = [v.m for r in out for v in r]
    assert len({id(s) for s in stores}) == len(stores)
    for req, r in zip(reqs, out):
        for lazy, got in zip(req, r):
            assert lazy.m.node.cached_store is got.m


# ---------------------------------------------------------------------------
# Fuzz: random 2–3-plan batches over shared sources == serial oracle
# ---------------------------------------------------------------------------

def _rand_request(fm, rng, X, Y):
    """One random lazy request over the shared sources."""
    base = [X, Y, X + Y, X * 0.5, fm.sqrt(fm.abs_(X) + 1.0)][rng.integers(5)]
    op = rng.integers(4)
    if op == 0:
        return fm.colMeans(base)
    if op == 1:
        return fm.sum_(base)
    if op == 2:
        return fm.crossprod(base)
    return fm.colMaxs(base)


@pytest.mark.parametrize("seed", range(6))
def test_batch_fuzz_matches_serial(seed):
    rng = np.random.default_rng(100 + seed)
    a = (rng.normal(size=(700, 4)) * 2).astype(np.float32)
    b = (rng.normal(size=(700, 4)) + 1).astype(np.float32)
    state = rng.bit_generator.state

    def program(fm):
        r = np.random.default_rng()
        r.bit_generator.state = state
        X = fm.conv_R2FM(a, host=True)
        Y = fm.conv_R2FM(b, host=True)
        k = int(r.integers(2, 4))
        return [_rand_request(fm, r, X, Y) for _ in range(k)]

    ref, port = both_batched(program)
    for side, batched in ((REF, ref), (PORT, port)):
        fm = side.fm
        for req, got in zip(program(fm), batched):
            (want,) = fm.materialize(req, mode="ooc")
            np.testing.assert_allclose(got, fm.as_np(want), rtol=2e-3,
                                       atol=1e-4)
