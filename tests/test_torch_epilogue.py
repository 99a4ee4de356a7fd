"""Twin of tests/test_epilogue.py: the port's plan EPILOGUE stage held
against the JAX package's.

Post-sink lazy math — ``colSums(X)/n``, ``sqrt(ss/n − mean²)``,
``solve(XᵀX, ·)`` — runs inside the plan of the sinks it consumes: one
pass, one epilogue launch, one plan-cache entry, in both packages on the
same numpy inputs (``helpers_twin.both``: equal counters, kernel dispatch,
shapes and dtypes), each held to the reference test's oracle.  Streams are
cut into 4 KiB partitions, as in the reference, and stream in ``stream``
and ``ooc`` mode too: ``test_colmeans_colsds_one_plan_one_epilogue`` in
stream mode, ``test_glm_style_solve_in_plan``,
``test_cached_plan_reuse_with_epilogue_iteration`` and
``test_ooc_ridge_eye_is_epilogue_source`` (its X in host RAM in place of
the reference's disk matrix, staged by the prefetcher in both packages).
``test_ooc_epilogue_inputs_on_device`` reads an ``.fmat`` file in each
package (the disk tier).
"""
import numpy as np
import pytest

from helpers_twin import (PORT, REF, _port_on_cpu, both,  # noqa: F401
                          both_conf, counting, data_dirs, save_both)
from helpers_twin import time_limit  # noqa: F401

pytestmark = pytest.mark.usefixtures("time_limit")

RNG = np.random.default_rng(3)

_CACHE = ("plan_cache_hits", "plan_cache_misses", "materialize_calls",
          "epilogue_launches", "partition_steps")


def _x(n=600, p=5):
    return (RNG.normal(size=(n, p)) * 2 + 0.5).astype(np.float32)


@pytest.fixture(autouse=True)
def _small_partitions():
    """Multi-partition streams, so the merge actually merges."""
    with both_conf(io_partition_bytes=4096):
        yield


def _each(fn):
    """``fn(side)`` on both packages; the results, reference first."""
    return [fn(side) for side in (REF, PORT)]


def test_sink_consumer_only_output_materializes():
    """A DAG whose only output is a sink-consumer goes through the
    epilogue."""
    a = _x()
    for (m,) in both(lambda fm: [fm.colSums(fm.conv_R2FM(a)) / float(len(a))]):
        np.testing.assert_allclose(m.reshape(-1), a.mean(0), rtol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_colmeans_colsds_one_plan_one_epilogue(backend, mode="whole"):
    """colMeans + colSds co-materialize: ONE pass over X, ONE epilogue
    launch, one plan-cache miss, parity with numpy."""
    a = _x()

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.colMeans(X), fm.colSds(X)]

    for side in (REF, PORT):
        X = side.fm.conv_R2FM(a)
        plan = side.Plan([o.m for o in program(side.fm)])
        assert plan.bytes_in() == X.m.nbytes()
        assert [s.kind for s in plan.ir.segments].count("epilogue") == 1
    acts = []
    for side, be in ((REF, "xla"), (PORT, backend)):
        with counting(side, _CACHE) as act:
            side.fm.materialize(*program(side.fm), backend=be, mode=mode)
        assert (act["plan_cache_misses"], act["plan_cache_hits"],
                act["epilogue_launches"], act["materialize_calls"]) \
            == (1, 0, 1, 1)
        acts.append(act)
    assert acts[1] == acts[0]
    for mu, sd in both(program, backend=backend, mode=mode):
        np.testing.assert_allclose(mu.reshape(-1), a.mean(0), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(sd.reshape(-1), a.std(0, ddof=1),
                                   rtol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_colmeans_colsds_one_plan_one_epilogue_stream(backend):
    """The reference's stream cell: the merge runs once per partition, the
    epilogue once."""
    test_colmeans_colsds_one_plan_one_epilogue(backend, mode="stream")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_glm_style_solve_in_plan(backend):
    """The IRLS shape: XᵀWX and XᵀWz sinks and the epilogue solve in one
    plan, streamed; ``cuda`` claims the weighted Gram per partition."""
    a = _x(800, 4)
    wv = np.abs(RNG.normal(size=(800,))).astype(np.float32) + 0.1
    zv = RNG.normal(size=(800, 1)).astype(np.float32)

    def program(fm):
        X, w, z = fm.conv_R2FM(a), fm.conv_R2FM(wv), fm.conv_R2FM(zv)
        return [fm.solve(fm.crossprod(fm.mapply_col(X, w, "mul"), X),
                         fm.crossprod(X, w * z))]

    for side in (REF, PORT):
        (beta,) = program(side.fm)
        assert beta.is_virtual
        plan = side.Plan([beta.m])
        assert plan.bytes_in() == a.nbytes + wv.nbytes + zv.nbytes
        assert "wgram" in [u.kernel for u in
                           plan.program(side.kernel_backend).kernel_units]
    A = (a * wv[:, None]).T.astype(np.float64) @ a
    rhs = a.T.astype(np.float64) @ (wv[:, None] * zv)
    for (b,) in both(program, backend=backend, mode="stream"):
        np.testing.assert_allclose(b, np.linalg.solve(A, rhs), rtol=1e-4,
                                   atol=1e-5)


def test_cached_plan_reuse_with_epilogue_iteration():
    """IRLS-style loop in stream mode: iteration N+1 (a new small beta)
    borrows the cached program, its epilogue included."""
    a = _x(500, 3)
    yv = RNG.normal(size=(500, 1)).astype(np.float32)
    G = a.T.astype(np.float64) @ a
    acts = []
    for side in (REF, PORT):
        fm = side.fm
        X, y = fm.conv_R2FM(a), fm.conv_R2FM(yv)
        with counting(side, _CACHE) as act:
            for it in range(3):
                r = y - X @ np.full((3, 1), float(it), np.float32)
                beta = fm.solve(fm.crossprod(X), fm.crossprod(X, r))
                (b_m,) = fm.materialize(beta, mode="stream")
                ref = np.linalg.solve(G, a.T.astype(np.float64)
                                      @ (yv - a @ np.full((3, 1), float(it),
                                                          np.float32)))
                np.testing.assert_allclose(fm.as_np(b_m), ref, rtol=1e-4,
                                           atol=1e-5)
        assert (act["plan_cache_misses"], act["plan_cache_hits"],
                act["epilogue_launches"]) == (1, 2, 3)
        acts.append(act)
    assert acts[1] == acts[0]


def test_ooc_ridge_eye_is_epilogue_source():
    """A small physical matrix consumed only by the epilogue (a ridge eye,
    itself in host RAM) is handed whole to the epilogue on the device,
    never streamed; X streams out of core from host RAM."""
    a = _x(512, 3)

    def program(fm):
        X = fm.conv_R2FM(a, host=True)
        eye = fm.conv_R2FM(np.eye(3, dtype=np.float32), host=True)
        return [fm.crossprod(X) + eye]

    for side in (REF, PORT):
        plan = side.Plan([o.m for o in program(side.fm)])
        assert len(plan.epilogue_sources) == 1
        assert plan.bytes_in() == a.nbytes  # the eye is not streamed
    for side in (REF, PORT):
        with counting(side, ("epilogue_launches", "epilogue_host_inputs",
                             "partition_steps")) as act:
            side.fm.materialize(*program(side.fm))
        assert act["epilogue_launches"] == 1
        assert act["epilogue_host_inputs"] == 0
        assert act["partition_steps"] > 1  # genuinely multi-partition
    for (am,) in both(program, mode="auto"):
        np.testing.assert_allclose(am, a.T.astype(np.float64) @ a
                                   + np.eye(3), rtol=1e-4)


def test_ooc_epilogue_inputs_on_device(data_dirs):
    """Disk-backed sources: the epilogue receives device tensors only — no
    memmap or numpy array leaks past the merge (``epilogue_host_inputs``
    records any) — and the stored results stay on the device; counters
    equal the reference's."""
    a = _x(700, 4)
    save_both(a, "epi_x")

    def program(fm):
        Xd = fm.get_dense_matrix("epi_x")
        assert Xd.m.on_disk
        return [fm.colMeans(Xd), fm.colSds(Xd)]

    for side in (REF, PORT):
        with counting(side, ("epilogue_launches", "epilogue_host_inputs",
                             "partition_steps")) as act:
            mu_m, sd_m = side.fm.materialize(*program(side.fm))
        assert act["epilogue_launches"] == 1
        assert act["epilogue_host_inputs"] == 0
        assert act["partition_steps"] > 1  # genuinely multi-partition ooc
        assert not mu_m.m.on_host and not sd_m.m.on_host
    mu, sd = both(program, mode="auto")[1]
    np.testing.assert_allclose(mu.reshape(-1), a.mean(0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sd.reshape(-1), a.std(0, ddof=1), rtol=1e-3)


def test_epilogue_rides_kernel_lowering():
    """The kernel backend still claims the sink chains below an epilogue
    (fused_apply_agg); the epilogue itself is never a kernel unit."""
    a = _x()
    for side in (REF, PORT):
        X = side.fm.conv_R2FM(a)
        plan = side.Plan([side.fm.colMeans(X).m, side.fm.colSds(X).m])
        prog = plan.program(side.kernel_backend)
        assert [u.kernel for u in prog.kernel_units] == ["fused_apply_agg"]
        assert prog.epilogue is not None


def test_solve_inverse_and_physical_operands():
    """solve(A) with a virtual Gram sink → epilogue inverse; physical
    operands keep the eager float64 path (non-virtual result)."""
    a = _x(300, 4)
    G = a.T.astype(np.float64) @ a
    for (inv_m,) in both(lambda fm: [fm.solve(fm.crossprod(fm.conv_R2FM(a)))]):
        np.testing.assert_allclose(inv_m, np.linalg.inv(G), rtol=1e-3,
                                   atol=1e-6)
    A = (G + 10 * np.eye(4)).astype(np.float32)
    for side in (REF, PORT):
        eager = side.fm.solve(side.fm.conv_R2FM(A))
        assert not eager.is_virtual
        np.testing.assert_allclose(side.fm.as_np(eager), np.linalg.inv(A),
                                   rtol=1e-4)


def test_solve_rhs_shapes():
    """A (1, n) vector sink is a one-column RHS; a (k, n) matrix is NOT
    silently truncated to a vector."""
    a = _x(300, 4)
    b = _x(2, 4)
    G = a.T.astype(np.float64) @ a

    def program(fm):
        X = fm.conv_R2FM(a)
        return [fm.solve(fm.crossprod(X), fm.colSums(X))]  # (1, 4) sink RHS

    for (x1,) in both(program):
        np.testing.assert_allclose(
            x1, np.linalg.solve(G, a.sum(0).reshape(-1, 1)), rtol=1e-3,
            atol=1e-5)
    msgs = []
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with pytest.raises(ValueError, match="solve shape mismatch") as ei:
            fm.solve(fm.crossprod(X), fm.conv_R2FM(b) + 0.0)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_epilogue_evaluated_sink():
    """A sink whose operand is itself post-sink (sum(colMeans(X))) runs its
    quartet inside the epilogue."""
    a = _x()
    for side in (REF, PORT):
        fm = side.fm
        tot = fm.sum_(fm.colMeans(fm.conv_R2FM(a)))
        plan = side.Plan([tot.m])
        assert [n.kind for n in plan.epilogue_nodes] == ["mapply", "agg"]
        assert plan.sinks and all(n.kind == "agg_col" for n in plan.sinks)
    for (t,) in both(lambda fm: [fm.sum_(fm.colMeans(fm.conv_R2FM(a)))]):
        assert abs(float(t.reshape(())) - a.mean(0).sum()) < 1e-4


def test_mean_and_scale_are_lazy():
    a = _x(400, 3)
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(a)
        m = fm.mean_(X)
        assert m.is_virtual
        assert abs(fm.as_scalar(m) - a.mean()) < 1e-5
        assert fm.scale(X).is_virtual  # moments lazy, the sweep lazy
    Zn = (a - a.mean(0)) / a.std(0, ddof=1)
    for (G,) in both(lambda fm: [fm.crossprod(fm.scale(fm.conv_R2FM(a)))]):
        np.testing.assert_allclose(G, Zn.T @ Zn, rtol=1e-3, atol=1e-3)


def test_cache_no_collision_with_and_without_epilogue():
    """The same sink requested bare vs feeding an epilogue are two cache
    entries; re-running each signature is a hit."""
    a = _x()

    def run(side):
        fm = side.fm
        X = fm.conv_R2FM(a)
        with counting(side, _CACHE) as act:
            fm.materialize(fm.colSums(X))
            fm.materialize(fm.colSums(X) / float(X.nrow))
            fm.materialize(fm.colSums(X))
            (mu_m,) = fm.materialize(fm.colSums(X) / float(X.nrow))
        np.testing.assert_allclose(fm.as_np(mu_m).reshape(-1), a.mean(0),
                                   rtol=1e-5)
        return act

    ref, port = _each(run)
    assert (ref["plan_cache_misses"], ref["plan_cache_hits"],
            ref["epilogue_launches"]) == (2, 2, 2)
    assert port == ref


def test_cache_no_collision_on_requested_epilogue_roots():
    """Which epilogue nodes are REQUESTED is part of the cache key:
    materialize([e, sum(e)]) and then materialize([sum(e)]) are two
    misses, and sum(e) is never handed the value of e."""
    a = _x()
    ref_e = np.sqrt(np.abs((a.astype(np.float64) ** 2).sum(0)
                           - a.astype(np.float64).sum(0) / 2.0))

    def run(side):
        fm = side.fm
        X = fm.conv_R2FM(a)

        def build():
            e = fm.sqrt(fm.abs_(fm.colSums(X ** 2) - fm.colSums(X) / 2.0))
            return e, fm.sum_(e)

        with counting(side, _CACHE) as act:
            e1, s1 = build()
            e_m, s_m = fm.materialize(e1, s1)
            _, s2 = build()
            (solo_m,) = fm.materialize(s2)
        np.testing.assert_allclose(fm.as_np(e_m).reshape(-1), ref_e,
                                   rtol=1e-4)
        for s in (s_m, solo_m):
            np.testing.assert_allclose(float(fm.as_scalar(s)), ref_e.sum(),
                                       rtol=1e-4)
        return act

    ref, port = _each(run)
    assert (ref["plan_cache_misses"], ref["plan_cache_hits"]) == (2, 0)
    assert port == ref


def test_epilogue_of_streaming_intermediate_rejected():
    """solve() of a row-local intermediate needs a second pass: the plan
    refuses with an actionable message."""
    a = _x(8, 8)  # square so the row-local chain shares the long dim
    for side in (REF, PORT):
        fm = side.fm
        bad = fm.solve(fm.conv_R2FM(a) + 1.0, np.ones((8, 1), np.float32))
        with pytest.raises(ValueError, match="streaming intermediate"):
            fm.materialize(bad)


def test_source_shared_by_loop_and_epilogue_rejected():
    from repro.core import dag as jdag, genops as jgenops
    from repro_torch.core import dag as tdag, genops as tgenops
    a = _x(4, 4)
    for side, dag, genops in ((REF, jdag, jgenops), (PORT, tdag, tgenops)):
        leaf = dag.wrap(dag.as_node(side.fm.conv_R2FM(a).m))
        sink = genops.agg_col(leaf.node, "sum")      # loop consumer
        inv = genops.solve(leaf.node)                # epilogue consumer
        with pytest.raises(ValueError, match="both the partition loop"):
            side.Plan([sink, inv])


def test_persisted_sink_as_cut_source_keeps_its_value():
    """A materialized sink reused as a SOURCE of a later plan must not
    re-register as that plan's sink (which would zero its value)."""
    a = _x(400, 3)
    for side in (REF, PORT):
        fm = side.fm
        s = fm.colSums(fm.conv_R2FM(a))
        fm.materialize(s)
        v1 = fm.as_np(s).copy()
        assert side.Plan([(s / 400.0).m]).sinks == []
        (mu_m,) = fm.materialize(s / 400.0)
        np.testing.assert_array_equal(fm.as_np(s), v1)  # value survived
        np.testing.assert_allclose(fm.as_np(mu_m).reshape(-1), a.mean(0),
                                   rtol=1e-5)


def test_eager_mode_epilogue_parity():
    """fuse=False: every post-sink node materializes as its own tiny plan
    (no epilogue), the same number of steps in both packages."""
    a = _x(300, 4)
    for (sd,) in both(lambda fm: [fm.colSds(fm.conv_R2FM(a))], fuse=False):
        np.testing.assert_allclose(sd.reshape(-1), a.std(0, ddof=1),
                                   rtol=1e-3)

    def run(side):
        with counting(side, _CACHE) as act:
            side.fm.materialize(side.fm.colSds(side.fm.conv_R2FM(a)),
                                fuse=False)
        return act

    ref, port = _each(run)
    assert ref["epilogue_launches"] == 0 and ref["partition_steps"] >= 5
    assert port == ref
