"""Twin of tests/test_multipass.py: the port's multi-pass planner held
against the JAX package's.

A DAG in which a merged value feeds a row-local op — ``scale(X)``,
``X - colMeans(X)``, PCA's centered Gram — schedules as an ordered pass
list under ONE plan-cache entry and ONE ``fm.materialize`` call, in both
packages on the same numpy inputs (``helpers_twin.both``: equal counters,
kernel dispatch, shapes and dtypes), each held to the reference test's
oracle.  Streams are cut into 4 KiB partitions, as in the reference.

The reference's stream and ooc cells run as it writes them:
``test_scale_one_call_two_passes`` and
``test_pca_covariance_of_centered_two_passes`` in stream mode and in ooc
mode from host RAM (``*_streaming``, the ooc cells through the background
prefetcher, the conf default, in both packages),
``test_sweep_helper_and_sink_binding``, ``test_three_pass_chain``,
``test_cache_keyed_on_per_pass_partition_schedule``,
``test_cached_two_pass_plan_reuse``, the interrupted passes with the
prefetcher off and ``test_interrupted_prefetching_pass_raises_prefetch_error``
with it on (the port's flaky store is ``helpers_twin.FlakyStore``).
``test_scale_save_disk_streams_out_of_core`` streams ``scale`` from an
``.fmat`` file into a spill file, pass 2 written through.
"""
import numpy as np
import pytest

from helpers_cache import StagingFault, assert_no_partial_results
from helpers_twin import (PORT, REF, _port_on_cpu, both,  # noqa: F401
                          both_conf, counting, data_dirs, flaky_matrix,
                          save_both)
from helpers_twin import time_limit  # noqa: F401
from repro.core import dag as jdag
from repro_torch.core import dag as tdag

pytestmark = pytest.mark.usefixtures("time_limit")

DAGS = {REF.name: jdag, PORT.name: tdag}

RNG = np.random.default_rng(7)

BACKENDS = ["torch", "cuda"]


def _x(n=600, p=5):
    return (RNG.normal(size=(n, p)) * 2 + 0.5).astype(np.float32)


@pytest.fixture(autouse=True)
def _small_partitions():
    """Multi-partition streams, so pass 2 genuinely re-streams."""
    with both_conf(io_partition_bytes=4096):
        yield


@pytest.mark.parametrize("backend", BACKENDS)
def test_scale_one_call_two_passes(backend, mode="whole"):
    a = _x()
    host = mode == "ooc"
    for side in (REF, PORT):
        X = side.fm.conv_R2FM(a, host=host)
        Z = side.fm.scale(X)
        assert Z.is_virtual  # the moments are DAG edges
        plan = side.Plan([Z.m])
        assert plan.n_passes == 2
        assert plan.bytes_in() == 2 * X.m.nbytes()
    stats = []
    for side, be in ((REF, "xla"), (PORT, backend)):
        side.mz.reset_exec_stats()
        with counting(side, ("materialize_calls", "plan_cache_misses",
                             "plan_cache_hits", "epilogue_launches")) as act:
            side.fm.materialize(
                side.fm.scale(side.fm.conv_R2FM(a, host=host)), backend=be,
                mode=mode)
        st = side.mz.exec_stats()
        assert act == {"materialize_calls": 1, "plan_cache_misses": 1,
                       "plan_cache_hits": 0, "epilogue_launches": 1}
        assert st["passes"] == 2
        stats.append(tuple(st["pass_bytes_in"]))
    assert stats[1] == stats[0] == (a.nbytes, a.nbytes)
    ref = (a - a.mean(0)) / a.std(0, ddof=1)
    for (Zm,) in both(lambda fm: [fm.scale(fm.conv_R2FM(a, host=host))],
                      backend=backend, mode=mode):
        np.testing.assert_allclose(Zm, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pca_covariance_of_centered_two_passes(backend, mode="whole"):
    """crossprod(X - colMeans(X)) / (n − 1): a pass-2 contraction consuming
    the pass-1 epilogue, with its own pass-2 epilogue."""
    a = _x(700, 4)

    def program(fm):
        X = fm.conv_R2FM(a, host=mode == "ooc")
        return [fm.crossprod(X - fm.colMeans(X)) / float(a.shape[0] - 1)]

    for side in (REF, PORT):
        plan = side.Plan([o.m for o in program(side.fm)])
        assert plan.n_passes == 2 and plan.passes[1].sinks
    c = a - a.mean(0)
    ref = c.T.astype(np.float64) @ c / (a.shape[0] - 1)
    for side, be in ((REF, "xla"), (PORT, backend)):
        side.mz.reset_exec_stats()
        side.fm.materialize(*program(side.fm), backend=be, mode=mode)
        st = side.mz.exec_stats()
        assert (st["passes"], st["epilogue_launches"]) == (2, 2)
    for (cm,) in both(program, backend=backend, mode=mode):
        np.testing.assert_allclose(cm, ref, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["stream", "ooc"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_scale_one_call_two_passes_streaming(backend, mode):
    """The reference's stream and ooc cells (ooc from host RAM)."""
    test_scale_one_call_two_passes(backend, mode=mode)


@pytest.mark.parametrize("mode", ["stream", "ooc"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_pca_covariance_of_centered_two_passes_streaming(backend, mode):
    test_pca_covariance_of_centered_two_passes(backend, mode=mode)


def test_sweep_helper_and_sink_binding():
    """fm.sweep with a lazy stat: a SINK value bound directly into the
    pass-2 row-local op, streamed."""
    a = _x(400, 3)
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        assert side.Plan([fm.sweep(X, 2, fm.colSums(X), "sub").m]) \
            .n_passes == 2
        with pytest.raises(ValueError, match="margin"):
            fm.sweep(X, 3, fm.colSums(X))

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.sweep(X, 2, fm.colSums(X), "sub")]

    for (sm,) in both(program, mode="stream"):
        np.testing.assert_allclose(sm, a - a.sum(0), rtol=1e-4, atol=1e-3)


def test_three_pass_chain():
    """Standardizing the CENTERED matrix by its own colSds: moment →
    center → sd-moment, three passes in one call, streamed."""
    a = _x(500, 4)

    def program(fm):
        X = fm.conv_R2FM(a)
        Z = X - fm.colMeans(X)
        return [Z / fm.colSds(Z)]

    for side in (REF, PORT):
        assert side.Plan([o.m for o in program(side.fm)]).n_passes == 3
    c = a - a.mean(0)
    for (wm,) in both(program, mode="stream"):
        np.testing.assert_allclose(wm, c / c.std(0, ddof=1), rtol=1e-3,
                                   atol=1e-3)


def test_cache_keyed_on_per_pass_partition_schedule():
    """Retuning the I/O partition budget retraces a multi-pass plan (the
    per-pass partition rows are in the cache key)."""
    a = _x()
    ref = (a - a.mean(0)) / a.std(0, ddof=1)
    acts = []
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with counting(side, ("plan_cache_misses", "plan_cache_hits",
                             "partition_steps")) as act:
            fm.materialize(fm.scale(X), mode="stream")
            with fm.conf(io_partition_bytes=8192):
                (Zm,) = fm.materialize(fm.scale(X), mode="stream")
        assert (act["plan_cache_misses"], act["plan_cache_hits"]) == (2, 0)
        np.testing.assert_allclose(fm.as_np(Zm), ref, rtol=1e-3, atol=1e-4)
        acts.append(act)
    assert acts[1] == acts[0]


def test_cached_two_pass_plan_reuse():
    """A structurally identical two-pass DAG built twice compiles once and
    hits on the second materialize."""
    a = _x()
    acts = []
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with counting(side, ("plan_cache_misses", "plan_cache_hits",
                             "epilogue_launches", "partition_steps",
                             "prefetch_reuse_hits")) as act:
            (z1,) = fm.materialize(fm.scale(X), mode="stream")
            (z2,) = fm.materialize(fm.scale(X), mode="stream")
        assert (act["plan_cache_misses"], act["plan_cache_hits"],
                act["epilogue_launches"]) == (1, 1, 2)
        np.testing.assert_allclose(fm.as_np(z1), fm.as_np(z2), rtol=1e-6)
        acts.append(act)
    assert acts[1] == acts[0]


@pytest.mark.parametrize("fail_after", [1, 0])
def test_interrupted_pass1_leaves_no_partial_sinks(fail_after):
    """A staging failure during PASS 1 aborts the materialize with nothing
    registered, the store's own error unchanged; a retry (healed store,
    same cached plan) succeeds."""
    a = _x(800, 4)
    ref = (a - a.mean(0)) / a.std(0, ddof=1)
    reads = []
    for side in (REF, PORT):
        fm = side.fm
        Xm, store = flaky_matrix(side, a, fail_after)
        Z = fm.scale(fm.FM(Xm))
        nodes = DAGS[side.name].toposort([Z.m.node])
        with pytest.raises(StagingFault, match="staging failure"):
            fm.materialize(Z, prefetch=False)
        assert store.failed
        assert_no_partial_results(*nodes)
        reads.append(store.reads)
        store.heal()
        (Zm,) = fm.materialize(Z, prefetch=False)
        np.testing.assert_allclose(fm.as_np(Zm), ref, rtol=1e-3, atol=1e-4)
    assert reads[1] == reads[0] == fail_after


def test_interrupted_pass2_rolls_back_pass1_sinks():
    """Pass 1 completes, pass 2 dies mid-stream: even the already merged
    pass-1 sinks do not register."""
    a = _x(800, 4)
    ref = (a - a.mean(0)) / a.std(0, ddof=1)
    for side in (REF, PORT):
        fm = side.fm
        n_parts = -(-800 // side.Plan([fm.scale(fm.conv_R2FM(a)).m])
                    .passes[0].partition_rows)
        assert n_parts > 1
        # Survive all of pass 1, die on the second read of pass 2.
        Xm, store = flaky_matrix(side, a, n_parts + 1)
        Z = fm.scale(fm.FM(Xm))
        nodes = DAGS[side.name].toposort([Z.m.node])
        with pytest.raises(StagingFault, match="staging failure"):
            fm.materialize(Z, prefetch=False)
        assert store.reads == n_parts + 1  # pass 2 actually started
        assert_no_partial_results(*nodes)
        store.heal()
        (Zm,) = fm.materialize(Z, prefetch=False)
        np.testing.assert_allclose(fm.as_np(Zm), ref, rtol=1e-3, atol=1e-4)


def test_interrupted_prefetching_pass_raises_prefetch_error():
    """With the prefetcher ON, the injected fault surfaces as a
    PrefetchError on the consumer side, naming the rows and the source —
    the same no-partial-results guarantee, the pass-2 re-drive included —
    and leaves no worker thread, staged partition or resident behind."""
    from repro.storage.prefetch import PrefetchError as JPrefetchError
    from repro_torch import storage as tstorage
    from repro_torch.core import materialize as tmz
    a = _x(800, 4)
    for side, err in ((REF, JPrefetchError), (PORT, tstorage.PrefetchError)):
        Xm, store = flaky_matrix(side, a, 1)
        Z = side.fm.scale(side.fm.FM(Xm))
        nodes = DAGS[side.name].toposort([Z.m.node])
        with pytest.raises(err, match=r"rows \[\d+, \d+\) of source "
                                      r"'flaky'.*staging failure"):
            side.fm.materialize(Z, prefetch=True)
        assert_no_partial_results(*nodes)
    assert tstorage.live_prefetchers() == []
    assert tstorage.staged_leaks() == []
    assert tmz._tls_residents() is None


def test_prefetch_on_a_multi_partition_host_source_raises_naming_a7a_ii():
    """Where ``prefetch`` resolves True — explicitly, or by the conf default
    over a host source of more than one partition — the partitions stream
    through the background prefetcher: the same three calls that raised
    naming ROADMAP A7a-ii before the prefetcher landed now run, each equal
    to the reference's with the counters exact, and each equal bit for bit
    to the port's synchronous run.  The rule's other arms: ``prefetch=
    False``, the conf knob off, one partition."""
    a = _x(800, 4)
    ref = (a - a.mean(0)) / a.std(0, ddof=1)
    assert -(-800 // PORT.Plan([PORT.fm.scale(PORT.fm.conv_R2FM(
        a, host=True)).m]).passes[0].partition_rows) > 1
    for kw in ({}, {"prefetch": True}, {"prefetch": True, "mode": "stream"}):
        got = []
        for side in (REF, PORT):
            X = side.fm.conv_R2FM(a, host=True)
            with counting(side, ("partition_steps", "passes", "streams",
                                 "stage_bytes_read",
                                 "prefetch_reuse_hits")) as act:
                (Zm,) = side.fm.materialize(side.fm.scale(X), **kw)
            np.testing.assert_allclose(side.fm.as_np(Zm), ref, rtol=1e-3,
                                       atol=1e-4)
            got.append((side.fm.as_np(Zm), act))
        assert got[1][1] == got[0][1] and got[1][1]["partition_steps"] > 2
        fm = PORT.fm
        (Zs,) = fm.materialize(fm.scale(fm.conv_R2FM(a, host=True)),
                               **dict(kw, prefetch=False))
        np.testing.assert_array_equal(got[1][0], fm.as_np(Zs))
    fm = PORT.fm
    X = fm.conv_R2FM(a, host=True)
    with fm.conf(prefetch=False):
        (Zm,) = fm.materialize(fm.scale(X))
    np.testing.assert_allclose(fm.as_np(Zm), ref, rtol=1e-3, atol=1e-4)
    with fm.conf(io_partition_bytes=1 << 20):  # one partition: no prefetch
        (Zm,) = fm.materialize(fm.scale(X))
    np.testing.assert_allclose(fm.as_np(Zm), ref, rtol=1e-3, atol=1e-4)


def test_scale_fuses_into_downstream_gram():
    """scale(X) stays lazy and fuses into a downstream Gram in one call."""
    a = _x(600, 4)
    z = (a - a.mean(0)) / a.std(0, ddof=1)
    for side in (REF, PORT):
        side.mz.reset_exec_stats()
        side.fm.materialize(side.fm.crossprod(side.fm.scale(
            side.fm.conv_R2FM(a))))
        st = side.mz.exec_stats()
        assert st["materialize_calls"] == 1 and st["passes"] == 2
    for (gm,) in both(lambda fm: [fm.crossprod(fm.scale(fm.conv_R2FM(a)))]):
        np.testing.assert_allclose(gm, z.T.astype(np.float64) @ z,
                                   rtol=2e-3, atol=1e-2)


def test_cache_no_collision_across_pass_structures():
    """A sweep by a LAZY stat (two passes) and by a PHYSICAL stat (one
    pass) are two cache entries, each signature carrying its passes."""
    a = _x()
    mu = a.mean(0).astype(np.float32)
    acts = []
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        p_lazy = side.Plan([fm.mapply_row(X, fm.colMeans(X), "sub").m])
        p_phys = side.Plan([fm.mapply_row(X, mu, "sub").m])
        assert p_lazy.n_passes == 2 and p_phys.n_passes == 1
        assert p_lazy.signature() != p_phys.signature()
        assert "P2" in p_lazy.signature() and "P1" in p_phys.signature()
        with counting(side, ("plan_cache_misses", "plan_cache_hits",
                             "passes")) as act:
            (lm,) = fm.materialize(fm.mapply_row(X, fm.colMeans(X), "sub"))
            (pm,) = fm.materialize(fm.mapply_row(X, mu, "sub"))
            fm.materialize(fm.mapply_row(X, fm.colMeans(X), "sub"))
            fm.materialize(fm.mapply_row(X, mu, "sub"))
        assert (act["plan_cache_misses"], act["plan_cache_hits"]) == (2, 2)
        np.testing.assert_allclose(fm.as_np(lm), a - a.mean(0), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(fm.as_np(pm), a - mu, rtol=1e-4,
                                   atol=1e-3)
        acts.append(act)
    assert acts[1] == acts[0]


def test_toposort_matches_the_reference():
    """dag.toposort: every node of scale(X)'s DAG, parents first, in the
    reference's depth-first order (the kinds and shapes, node by node)."""
    a = _x(50, 3)
    orders = []
    for side, dag in ((REF, jdag), (PORT, tdag)):
        Z = side.fm.scale(side.fm.conv_R2FM(a))
        order = dag.toposort([Z.m.node])
        pos = {n.id: i for i, n in enumerate(order)}
        assert order[-1] is Z.m.node and len(pos) == len(order)
        assert all(pos[p.id] < pos[n.id]
                   for n in order for p in n.parent_nodes())
        assert dag.toposort([Z.m.node, order[0]]) == order
        orders.append([(n.kind, n.shape) for n in order])
    assert orders[1] == orders[0]


def test_pca_single_materialize_two_passes():
    from repro.algorithms.pca import pca as jpca
    from repro_torch.algorithms.pca import pca as tpca
    a = _x(700, 5)
    c = a - a.mean(0)
    ev = np.linalg.eigvalsh(
        c.T.astype(np.float64) @ c / (a.shape[0] - 1))[::-1]
    stats = []
    for side, pca in ((REF, jpca), (PORT, tpca)):
        side.mz.reset_exec_stats()
        r = pca(side.fm.conv_R2FM(a), k=5)
        st = side.mz.exec_stats()
        assert st["materialize_calls"] == 1 and st["passes"] == 2
        stats.append({k: st[k] for k in ("passes", "partition_steps",
                                         "epilogue_launches")})
        np.testing.assert_allclose(r.sdev ** 2, ev, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(r.center, a.mean(0), rtol=1e-4, atol=1e-4)
    assert stats[1] == stats[0]


def test_glm_standardize_first_iteration_two_passes():
    from repro.algorithms.glm import glm as jglm, glm_predict as jpredict
    from repro_torch.algorithms.glm import glm as tglm, glm_predict as tpredict
    rng = np.random.default_rng(11)
    a = (rng.normal(size=(600, 4)) * 3 + 2).astype(np.float32)
    zs = (a - a.mean(0)) / a.std(0, ddof=1)
    beta_true = rng.normal(size=4)
    pv = 1.0 / (1.0 + np.exp(-(zs.astype(np.float64) @ beta_true)))
    y = (rng.uniform(size=600) < pv).astype(np.float32)
    # Oracle: IRLS on the standardized design.
    Zs = ((a - a.mean(0)) / np.maximum(a.std(0, ddof=1), 1e-12)) \
        .astype(np.float64)
    b = np.zeros(4)
    for _ in range(50):
        eta = Zs @ b
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu) + 1e-6
        z = eta + (y - mu) / w
        b = np.linalg.solve(Zs.T @ (Zs * w[:, None]), Zs.T @ (w * z))
    stats = []
    for side, glm, predict in ((REF, jglm, jpredict), (PORT, tglm, tpredict)):
        fm = side.fm
        side.mz.reset_exec_stats()
        res = glm(fm.conv_R2FM(a), fm.conv_R2FM(y), "logistic",
                  standardize=True)
        st = side.mz.exec_stats()
        # Only iteration 1 pays the moment pass; iterations 2+ are one-pass.
        assert st["passes"] == st["materialize_calls"] + 1
        # The counters of each call; how many calls there are is not
        # compared: the stopping rule (tol 1e-8 on the loglik, under f32's
        # resolution) ends on a repeat of the f32 loglik, which the
        # packages' sums reach at different iterations (ROADMAP §C).
        calls = st["materialize_calls"]
        stats.append((st["passes"] - calls, st["epilogue_launches"] - calls,
                      st["partition_steps"] - st["passes"]))
        assert res.center is not None and res.scale is not None
        np.testing.assert_allclose(res.beta, b, rtol=1e-3, atol=1e-3)
        pred = fm.as_np(predict(res, fm.conv_R2FM(a))).reshape(-1)
        np.testing.assert_allclose(pred, 1.0 / (1.0 + np.exp(-(Zs @ b))),
                                   rtol=1e-2, atol=1e-3)
    assert stats[1] == stats[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_scale_save_disk_streams_out_of_core(backend, data_dirs):
    """scale() of a disk matrix with save='disk': two passes, both
    streamed, pass 2's sweep written through to a spill file (disk to
    disk, never whole in RAM); counters equal the reference's and the
    spill file's body equals the reference's within the tolerance."""
    a = _x(800, 4)
    save_both(a, "mp_spill_x")

    def program(fm):
        Xd = fm.get_dense_matrix("mp_spill_x")
        assert Xd.m.on_disk
        return [fm.scale(Xd, save="disk")]

    stats = []
    for side in (REF, PORT):
        with counting(side, ("passes", "partition_steps",
                             "epilogue_host_inputs")) as st:
            (Zm,) = side.fm.materialize(
                *program(side.fm),
                **({"backend": backend} if side is PORT else {}))
        assert st["passes"] == 2
        assert st["partition_steps"] > 2     # genuinely streamed, both passes
        assert st["epilogue_host_inputs"] == 0
        assert Zm.m.on_disk                  # disk → disk
        ref = (a - a.mean(0)) / a.std(0, ddof=1)
        np.testing.assert_allclose(np.asarray(Zm.m.logical_data()), ref,
                                   rtol=1e-3, atol=1e-4)
        stats.append((st, np.array(Zm.m.logical_data())))
    assert stats[1][0] == stats[0][0]
    np.testing.assert_allclose(stats[1][1], stats[0][1], rtol=1e-5,
                               atol=1e-6)
    both(program, backend=backend, mode="auto")
