"""Twin of tests/test_serve.py: ``fm.serve`` / `Engine` in the port against
the JAX package.

Every test of the reference file but one runs here: the reference's body
in each package in turn — the port on the CPU, ``torch`` backend — with
the reference's inputs (``_x``, seed 23), its paced store (a ``PacedStore``
over each package's ``DenseStore``), its 4 KiB partitions and its
tolerances.  Every counter the reference asserts is asserted in both
packages, exactly; where a program's schedule is deterministic (a window
closed by ``max_window_requests``, a join through synchronous staging),
the packages' counters (``helpers_twin.COUNTERS``, the tenants' scope
stats) are also held equal to each other.  Every thread join and every
``result()`` has a timeout, and each test runs under
``helpers_twin.time_limit``: a deadlock fails the test.

One case is added: the 'auto' in-flight cap holding a group back behind
a larger one, in both packages (a reference-side fact, ROADMAP §C).

Left to the multi-GPU slice (ROADMAP A13):
``test_serve_under_mesh_shards_groups_and_serializes_admission``, the
reference's serving under a mesh.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

import helpers_cache
import helpers_twin
from helpers_cache import StagingFault, assert_no_partial_results
from helpers_twin import (PORT, REF, _port_on_cpu, both_conf,  # noqa: F401
                          counting, data_dirs, flaky_matrix, time_limit)
from repro import storage as jstorage
from repro.core import batch as jbatch
from repro.core import serve as jserve
from repro.core.matrix import DenseStore as JDenseStore
from repro.core.matrix import FMMatrix as JFMMatrix
from repro.storage.prefetch import PrefetchError as JPrefetchError
from repro_torch import storage as tstorage
from repro_torch.core import batch as tbatch
from repro_torch.core import serve as tserve
from repro_torch.core.matrix import DenseStore as TDenseStore
from repro_torch.core.matrix import FMMatrix as TFMMatrix
from repro_torch.storage.prefetch import PrefetchError as TPrefetchError

pytestmark = pytest.mark.usefixtures("time_limit")


@dataclasses.dataclass(frozen=True)
class Pkg:
    """What the reference test imports, from one package."""
    side: object
    serve: object
    batch: object
    storage: object
    DenseStore: type
    FMMatrix: type
    FlakyStore: type
    faults: tuple
    backend: str

    @property
    def fm(self):
        return self.side.fm

    @property
    def mz(self):
        return self.side.mz

    @property
    def metrics(self):
        return self.side.metrics

    def plan_request(self, req) -> bool:
        if self.side is REF:
            return self.batch._plan_request(req, self.backend, None, True)
        return self.batch._plan_request(req, self.backend, True)


# A staging fault may surface raw (inline staging) or wrapped by the
# prefetch worker, depending on the prefetch heuristic.
PKGS = [
    Pkg(REF, jserve, jbatch, jstorage, JDenseStore, JFMMatrix,
        helpers_cache.FlakyStore, (StagingFault, JPrefetchError), "xla"),
    Pkg(PORT, tserve, tbatch, tstorage, TDenseStore, TFMMatrix,
        helpers_twin.FlakyStore, (StagingFault, TPrefetchError), "torch"),
]

RNG = np.random.default_rng(23)


def _x(n=3000, p=6, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    return (rng.normal(size=(n, p)) * 2 + 0.5).astype(np.float32)


@pytest.fixture(autouse=True)
def _small_partitions():
    """Multi-partition streams, fresh plan caches and metrics per test (the
    suite's conftest resets the reference's metrics only)."""
    with both_conf(io_partition_bytes=4096):
        for pkg in PKGS:
            pkg.mz.clear_plan_cache()
        PORT.metrics.REGISTRY.reset()
        yield
    for pkg in PKGS:
        pkg.mz.clear_plan_cache()
    PORT.metrics.REGISTRY.reset()


def _submit_from_threads(eng, requests):
    """Submit each request from its own thread (barrier-released), return
    the handles in request order."""
    barrier = threading.Barrier(len(requests))
    handles = [None] * len(requests)
    errors = []

    def worker(i, outs):
        try:
            barrier.wait(timeout=30)
            handles[i] = eng.submit(*outs)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker,
                                args=(i, outs if isinstance(outs, tuple)
                                      else (outs,)))
               for i, outs in enumerate(requests)]
    _run_threads(threads, 60)
    assert not errors, errors
    return handles


def _run_threads(threads, timeout):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


def _paced_store(pkg):
    """The reference's ``PacedStore`` over ``pkg``'s ``DenseStore``: signals
    ``started`` after its second partition read, then holds the stream
    until ``release`` — a late request is submitted while the sweep is
    provably live."""

    class PacedStore(pkg.DenseStore):
        def __init__(self, arr, started, release):
            super().__init__(np.asarray(arr))
            self.reads = 0
            self.started = started
            self.release = release

        def block(self, start, stop):
            self.reads += 1
            if self.reads == 2:
                self.started.set()
                self.release.wait(timeout=30)
            return super().block(start, stop)

    return PacedStore


def _paced(pkg, a, name):
    started, release = threading.Event(), threading.Event()
    store = _paced_store(pkg)(a, started, release)
    return pkg.FMMatrix(a.shape, a.dtype, store=store, name=name), started, \
        release


def _np(pkg, r):
    return np.asarray(pkg.fm.as_np(r))


# ---------------------------------------------------------------------------
# Tentpole: window coalescing, bytes, attribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["stream", "ooc"])
def test_window_coalesces_concurrent_requests(mode):
    a = _x()
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=(mode == "ooc"))
        reqs = [fm.colMeans(X), fm.colSums(X),
                (fm.colSds(X), fm.crossprod(X)), fm.sum_(X)]
        pkg.mz.reset_exec_stats()
        with counting(pkg.side) as c:
            with fm.serve(window_ms=2000, max_window_requests=len(reqs),
                          mode=mode, midstream_admission=False) as eng:
                handles = _submit_from_threads(eng, reqs)
                res = [h.result(timeout=120) for h in handles]
        st = pkg.mz.exec_stats()
        # k concurrent same-source requests: ONE physical sweep, k passes.
        assert st["streams"] == 1
        assert st["passes"] == len(reqs)
        assert st["pass_bytes_in"] == (X.m.nbytes(),)
        np.testing.assert_allclose(_np(pkg, res[0]).ravel(), a.mean(0),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(pkg, res[1]).ravel(), a.sum(0),
                                   rtol=1e-3)
        np.testing.assert_allclose(_np(pkg, res[2][0]).ravel(),
                                   a.std(0, ddof=1), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(pkg, res[2][1]),
                                   a.T.astype(np.float64) @ a, rtol=2e-3)
        np.testing.assert_allclose(float(_np(pkg, res[3]).reshape(())),
                                   a.sum(), rtol=1e-3)
        got[pkg.side.name] = c
    assert got[PORT.name] == got[REF.name]


def test_served_bytes_strictly_below_serial():
    a = _x(2400, 6)
    got = {}
    for pkg in PKGS:
        fm, mz = pkg.fm, pkg.mz
        X = fm.conv_R2FM(a, host=True)

        def fresh_reqs():
            return [fm.colMeans(X), fm.colSums(X), fm.sum_(X)]

        mz.reset_exec_stats()
        for r in fresh_reqs():
            fm.materialize(r, mode="ooc")
        serial_bytes = pkg.metrics.root_counter("bytes_streamed")

        mz.clear_plan_cache()
        mz.reset_exec_stats()
        with fm.serve(window_ms=2000, max_window_requests=3,
                      mode="ooc", midstream_admission=False) as eng:
            for h in _submit_from_threads(eng, fresh_reqs()):
                h.result(timeout=120)
        served_bytes = pkg.metrics.root_counter("bytes_streamed")
        assert served_bytes < serial_bytes
        assert served_bytes == X.m.nbytes()  # union read exactly once
        got[pkg.side.name] = (serial_bytes, served_bytes)
    assert got[PORT.name] == got[REF.name]


def test_multipass_request_in_window():
    """A two-pass plan (scale: moment pass -> sweep pass) served alongside
    a single-pass request resolves correctly across rounds."""
    a = _x(1500, 5)
    oracle = (a - a.mean(0)) / a.std(0, ddof=1)
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=True)
        with counting(pkg.side) as c:
            with fm.serve(window_ms=2000, max_window_requests=2,
                          midstream_admission=False) as eng:
                handles = _submit_from_threads(
                    eng, [fm.scale(X), fm.colMeans(X)])
                scaled, mu = [h.result(timeout=120) for h in handles]
        np.testing.assert_allclose(_np(pkg, scaled), oracle, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(pkg, mu).ravel(), a.mean(0),
                                   rtol=1e-3, atol=1e-4)
        got[pkg.side.name] = c
    assert got[PORT.name] == got[REF.name]


def test_per_request_scope_attribution():
    """Each tenant's fm.collect_stats() scope sees ITS plan's share: one
    stream, its own bytes — not the group's union."""
    a = _x(2000, 4)
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=True)
        own_bytes = X.m.nbytes()
        eng = pkg.serve.Engine(window_ms=2000, max_window_requests=2,
                               midstream_admission=False)
        stats = [None, None]
        barrier = threading.Barrier(2)

        def tenant(i, out):
            with fm.collect_stats(f"tenant{i}") as sc:
                barrier.wait(timeout=30)
                eng.submit(out).result(timeout=120)
            stats[i] = sc.stats()

        try:
            _run_threads(
                [threading.Thread(target=tenant, args=(0, fm.colMeans(X))),
                 threading.Thread(target=tenant, args=(1, fm.sum_(X)))],
                120)
        finally:
            eng.close()
        for st in stats:
            assert st is not None
            assert st["streams"] == 1
            assert st["passes"] == 1
            assert st["bytes_streamed"] == own_bytes
            assert st["pass_bytes_in"] == (own_bytes,)
            assert st["materialize_calls"] == 1
        got[pkg.side.name] = [
            {k: st[k] for k in ("streams", "passes", "bytes_streamed",
                                "pass_bytes_in", "materialize_calls",
                                "partition_steps")} for st in stats]
    assert got[PORT.name] == got[REF.name]


def test_no_partial_sinks_when_member_fails_midgroup():
    """A staging fault inside one group fails every member of THAT group
    with no partial sinks; an unrelated group in the same window still
    completes.  Healing the store lets a resubmit succeed through the
    same (undamaged) cached template."""
    a = _x(1600, 5)
    b = _x(1600, 5, seed=7)
    for pkg in PKGS:
        fm = pkg.fm
        Fm, fstore = flaky_matrix(pkg.side, a, fail_after=3)
        F = fm.FM(Fm)
        Y = fm.conv_R2FM(b, host=True)
        flaky_reqs = [fm.colMeans(F), fm.sum_(F)]
        with fm.serve(window_ms=2000, max_window_requests=3, mode="ooc",
                      midstream_admission=False) as eng:
            handles = _submit_from_threads(eng, flaky_reqs
                                           + [fm.colMeans(Y)])
            for h in handles[:2]:
                with pytest.raises(pkg.faults):
                    h.result(timeout=120)
            np.testing.assert_allclose(
                _np(pkg, handles[2].result(120)).ravel(), b.mean(0),
                rtol=1e-3, atol=1e-4)
            assert_no_partial_results(*[r.m.node for r in flaky_reqs])

            fstore.heal()
            h = eng.submit(*flaky_reqs)
            r1, r2 = h.result(timeout=120)
            np.testing.assert_allclose(_np(pkg, r1).ravel(), a.mean(0),
                                       rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(float(_np(pkg, r2).reshape(())),
                                       a.sum(), rtol=1e-3)


# ---------------------------------------------------------------------------
# Mid-stream admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [False, True])
def test_midstream_admission_at_partition_boundary(prefetch):
    a = _x(8000, 8)
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X, started, release = _paced(pkg, a, "paced")
        pkg.mz.reset_exec_stats()
        with counting(pkg.side) as c:
            with fm.serve(window_ms=1, prefetch=prefetch) as eng:
                h1 = eng.submit(fm.colMeans(X))
                assert started.wait(timeout=30), "stream never started"
                # The sweep is live (partition 0 consumed or staged): this
                # request must ride it from the next boundary, not wait for
                # a new window.
                h2 = eng.submit(fm.colSums(X))
                release.set()
                r1 = h1.result(timeout=120)
                r2 = h2.result(timeout=120)
        st = pkg.mz.exec_stats()
        assert st["midstream_admits"] == 1
        assert st["streams"] == 1          # no second sweep
        assert st["passes"] == 2
        # Catch-up of the missed prefix is exact: full-precision parity.
        np.testing.assert_allclose(_np(pkg, r1).ravel(), a.mean(0),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(pkg, r2).ravel(), a.sum(0),
                                   rtol=1e-3)
        if not prefetch:
            # Synchronous staging: the late request was parked while the
            # sweep waited on partition 1's read, so it joins there and
            # the catch-up re-stages exactly partition 0.
            rows = pkg.side.Plan([fm.colMeans(X).m]).passes[0] \
                .partition_rows
            assert c["bytes_streamed"] == X.nbytes() + rows * a.shape[1] * 4
        got[pkg.side.name] = (c if not prefetch else
                              {k: st[k] for k in ("midstream_admits",
                                                  "streams", "passes")})
    assert got[PORT.name] == got[REF.name]


def test_submit_after_stream_done_uses_new_window():
    a = _x(1200, 4)
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=True)
        pkg.mz.reset_exec_stats()
        with counting(pkg.side) as c:
            with fm.serve(window_ms=1) as eng:
                h1 = eng.submit(fm.colMeans(X))
                h1.result(timeout=120)        # first stream fully done
                h2 = eng.submit(fm.colSums(X))
                h2.result(timeout=120)
        st = pkg.mz.exec_stats()
        assert st["midstream_admits"] == 0
        assert st["streams"] == 2
        got[pkg.side.name] = c
    assert got[PORT.name] == got[REF.name]


def test_gate_rejects_device_resident_long_outputs():
    """A late plan with a device-target long-dimension output cannot join a
    device-mode sweep (partition-order concatenation would scramble), but a
    sink-only plan can; in ooc mode the output is row-addressed on host and
    both qualify."""
    a = _x(1600, 4)
    b = _x(1600, 4, seed=3)
    for pkg in PKGS:
        fm, Gate = pkg.fm, pkg.serve._Gate
        Xd = fm.conv_R2FM(a, host=False)   # device tier -> 'stream' mode
        Xh = fm.conv_R2FM(a, host=True)    # host tier -> 'ooc' mode

        def request(out):
            req = pkg.batch.BatchRequest([out.m], structured=False)
            assert pkg.plan_request(req)
            return req

        def gate_for(out, to_host, rows=None):
            member = pkg.batch._member_for(request(out), 0)
            ps = member.ps
            ids = frozenset(id(m) for _, m in
                            ps.staged_sources(member.sources))
            return Gate(ps.long_dim, rows if rows is not None
                        else ps.partition_rows, ids, to_host=to_host)

        # rows=1: the sweep granularity never disqualifies, isolating the
        # output-residency check.
        gate = gate_for(fm.colMeans(Xd), to_host=False, rows=1)
        assert gate.accepts(request(fm.sum_(Xd)))
        assert not gate.accepts(request(fm.sqrt(fm.abs_(Xd))))

        gate_h = gate_for(fm.colMeans(Xh), to_host=True, rows=1)
        rowlocal_h = request(fm.sqrt(fm.abs_(Xh)))
        assert gate_h.accepts(rowlocal_h)       # host-addressed: fine

        # A late plan whose partitions are FINER than the live sweep
        # cannot consume the sweep's partitions whole.
        gate_coarse = gate_for(fm.colMeans(Xh), to_host=True)
        assert gate_coarse.rows > rowlocal_h.plan.passes[0].partition_rows
        assert not gate_coarse.accepts(rowlocal_h)

        # Multi-pass and foreign-source requests never ride a gate.
        assert not gate_h.accepts(request(fm.scale(Xh)))
        assert not gate_h.accepts(request(fm.colMeans(
            fm.conv_R2FM(b, host=True))))

        # A closed gate refuses offers; leftovers come back for re-queueing.
        g = Gate(1600, 1, frozenset(), to_host=True)
        assert g.offer("req", "member")
        assert g.close() == ["req"]
        assert not g.offer("req2", "member2")


def test_midstream_admitted_scope_attribution():
    a = _x(8000, 8)
    got = {}
    for pkg in PKGS:
        fm = pkg.fm
        X, started, release = _paced(pkg, a, "paced")
        with fm.serve(window_ms=1, prefetch=False) as eng:
            h1 = eng.submit(fm.colMeans(X))
            assert started.wait(timeout=30)
            with fm.collect_stats("late") as sc:
                h2 = eng.submit(fm.colSums(X))
                release.set()
                h2.result(timeout=120)
            h1.result(timeout=120)
        st = sc.stats()
        # The late tenant sees a solo-run view: one stream, its full bytes.
        assert st["streams"] == 1
        assert st["passes"] == 1
        assert st["bytes_streamed"] == X.nbytes()
        got[pkg.side.name] = {k: st[k] for k in (
            "streams", "passes", "bytes_streamed", "partition_steps",
            "materialize_calls")}
    assert got[PORT.name] == got[REF.name]


# ---------------------------------------------------------------------------
# Admission control + prefetch depth negotiation
# ---------------------------------------------------------------------------

def test_bandwidth_cap_defers_second_group():
    a = _x(4000, 6)
    b = _x(4000, 6, seed=5)
    for pkg in PKGS:
        fm, metrics = pkg.fm, pkg.metrics
        Xa, started, release = _paced(pkg, a, "paced-a")
        Xb = fm.conv_R2FM(b, host=True)
        pkg.mz.reset_exec_stats()
        # Cap of 1 byte: any group defers while another is in flight; the
        # "always admit when idle" rule keeps it deadlock-free.
        with fm.serve(window_ms=2000, max_window_requests=2,
                      max_concurrent_streams=2, max_inflight_bytes=1,
                      midstream_admission=False) as eng:
            handles = _submit_from_threads(
                eng, [fm.colMeans(Xa), fm.colMeans(Xb)])
            assert started.wait(timeout=30)
            # Group A is provably mid-stream; group B must be deferring now
            # or have already recorded its deferral.
            t0 = time.perf_counter()
            while (metrics.root_counter("serve_deferrals") < 1
                   and time.perf_counter() - t0 < 30.0):
                time.sleep(0.01)
            release.set()
            ra, rb = [h.result(timeout=120) for h in handles]
        assert metrics.root_counter("serve_deferrals") >= 1
        assert metrics.root_counter("serve_admission_wait_seconds") > 0
        np.testing.assert_allclose(_np(pkg, ra).ravel(), a.mean(0),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(pkg, rb).ravel(), b.mean(0),
                                   rtol=1e-3, atol=1e-4)


def test_auto_cap_defers_a_group_larger_than_its_window(monkeypatch):
    """``max_inflight_bytes='auto'`` (ROADMAP §C): no cap until staging
    telemetry exists; then ``bandwidth_window_s`` of the measured staging
    rate, floored at MIN_INFLIGHT_BYTES — a group larger than that holds
    the next group back although a worker is free, in both packages (at
    Friendster-32 an 8.4 GB group against a ~2.5 GB cap)."""
    a = _x(4000, 6)
    b = _x(4000, 6, seed=5)
    for pkg in PKGS:
        fm, metrics = pkg.fm, pkg.metrics
        monkeypatch.setattr(pkg.serve, "MIN_INFLIGHT_BYTES", 1)
        Xa, started, release = _paced(pkg, a, "paced-a")
        Xb = fm.conv_R2FM(b, host=True)
        pkg.mz.reset_exec_stats()
        with fm.serve(window_ms=2000, max_window_requests=2,
                      max_concurrent_streams=2, bandwidth_window_s=1e-9,
                      midstream_admission=False) as eng:
            assert eng._current_cap() is None      # nothing measured yet
            fm.materialize(fm.colSums(Xb), mode="ooc")  # stages: measured
            assert eng._current_cap() < Xb.m.nbytes()
            handles = _submit_from_threads(
                eng, [fm.colMeans(Xa), fm.colMeans(Xb)])
            assert started.wait(timeout=30)
            t0 = time.perf_counter()
            while (metrics.root_counter("serve_deferrals") < 1
                   and time.perf_counter() - t0 < 30.0):
                time.sleep(0.01)
            release.set()
            ra, rb = [h.result(timeout=120) for h in handles]
        assert metrics.root_counter("serve_deferrals") == 1
        np.testing.assert_allclose(_np(pkg, ra).ravel(), a.mean(0),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(pkg, rb).ravel(), b.mean(0),
                                   rtol=1e-3, atol=1e-4)


def test_negotiate_depth_group_aware():
    for pkg in PKGS:
        negotiate_depth = pkg.storage.prefetch.negotiate_depth
        assert negotiate_depth(1, 1 << 20, base=2) == 2       # solo
        assert negotiate_depth(4, 1 << 20, base=2) == 5       # +1 a member
        assert negotiate_depth(32, 1 << 20, base=2) == 8      # ceiling
        assert negotiate_depth(4, 1 << 20, base=2,
                               budget_bytes=2 << 20) == 2     # budget clamp
        assert negotiate_depth(4, 8 << 20, base=2,
                               budget_bytes=1 << 20) == 1     # floor at 1


def test_engine_close_drains_pending():
    a = _x(1200, 4)
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=True)
        eng = fm.serve(window_ms=60_000)   # window far longer than the test
        h = eng.submit(fm.colMeans(X))
        eng.close()                        # must cut the window short
        np.testing.assert_allclose(_np(pkg, h.result(timeout=10)).ravel(),
                                   a.mean(0), rtol=1e-3, atol=1e-4)
        with pytest.raises(RuntimeError):
            eng.submit(fm.colSums(X))


def test_physical_passthrough_resolves_immediately():
    a = _x(600, 3)
    for pkg in PKGS:
        fm = pkg.fm
        X = fm.conv_R2FM(a, host=False)
        with fm.serve(window_ms=60_000) as eng:   # scheduler never needed
            h = eng.submit(X)
            assert h.done()
            np.testing.assert_allclose(_np(pkg, h.result(0)), a, rtol=1e-6)


# ---------------------------------------------------------------------------
# Thread-safety audit regressions
# ---------------------------------------------------------------------------

def _threads_each(n_threads, body, timeout):
    """Run ``body(i)`` on ``n_threads`` barrier-released threads; the
    errors they raised."""
    errors = []
    barrier = threading.Barrier(n_threads)

    def worker(i):
        try:
            barrier.wait(timeout=30)
            body(i)
        except Exception as exc:  # noqa: BLE001
            errors.append((i, exc))

    _run_threads([threading.Thread(target=worker, args=(i,))
                  for i in range(n_threads)], timeout)
    return errors


def test_concurrent_materialize_through_one_cached_template():
    """N threads repeatedly materialize structurally identical plans over
    their OWN data through one shared plan-cache template: the borrow
    discipline (_store_results onto=) keeps every result correct."""
    n_threads, iters = 4, 6
    datas = [_x(900, 4, seed=i) for i in range(n_threads)]
    for pkg in PKGS:
        fm = pkg.fm

        def body(i):
            for _ in range(iters):
                X = fm.conv_R2FM(datas[i], host=True)
                (r,) = fm.materialize(fm.colMeans(X), mode="ooc")
                np.testing.assert_allclose(
                    _np(pkg, r).ravel(), datas[i].mean(0), rtol=1e-3,
                    atol=1e-4)

        errors = _threads_each(n_threads, body, 180)
        assert not errors, errors


def test_plan_cache_lru_eviction_racing_borrows(monkeypatch):
    """Concurrent materializes churning a 2-entry cache: eviction may drop
    a template another thread is borrowing — results must stay correct."""
    n_threads, iters = 4, 5
    datas = [_x(700, 3 + i, seed=10 + i) for i in range(n_threads)]
    for pkg in PKGS:
        fm = pkg.fm
        monkeypatch.setattr(pkg.mz, "PLAN_CACHE_LIMIT", 2)

        def body(i):
            for _ in range(iters):
                X = fm.conv_R2FM(datas[i], host=True)
                (r,) = fm.materialize(fm.colSums(X), mode="ooc")
                np.testing.assert_allclose(
                    _np(pkg, r).ravel(), datas[i].sum(0), rtol=1e-3)

        errors = _threads_each(n_threads, body, 180)
        assert not errors, errors
        assert len(pkg.mz._PLANS) <= 2


def test_data_dir_lazy_init_is_threadsafe(monkeypatch):
    for pkg in PKGS:
        registry = pkg.storage.registry
        monkeypatch.setitem(registry._CONF, "data_dir", None)
        results = []
        errors = _threads_each(8, lambda i: results.append(
            registry.data_dir()), 30)
        assert not errors, errors
        assert len(results) == 8
        assert len({str(p) for p in results}) == 1  # ONE dir, not eight


def test_program_compile_is_single_and_shared():
    a = _x(1000, 4)
    for pkg in PKGS:
        X = pkg.fm.conv_R2FM(a, host=True)
        plan = pkg.side.Plan([pkg.fm.colMeans(X).m])
        progs = [None] * 6

        def body(i):
            progs[i] = plan.program(pkg.backend)

        errors = _threads_each(6, body, 60)
        assert not errors, errors
        assert all(p is progs[0] and p is not None for p in progs)


def test_mixed_materialize_batch_serve_stress(data_dirs):
    """N threads mixing fm.materialize, fm.batch and Engine.submit against
    shared NAMED disk matrices, every result checked against numpy."""
    a = _x(2000, 5, seed=40)
    b = _x(2000, 5, seed=41)
    for pkg in PKGS:
        fm = pkg.fm
        A = fm.load_dense_matrix(a, "stress_a")
        B = fm.load_dense_matrix(b, "stress_b")
        eng = pkg.serve.Engine(window_ms=10, max_concurrent_streams=2)

        def check(res, arr, kind):
            got = _np(pkg, res).ravel()
            want = arr.mean(0) if kind == "mean" else arr.sum(0)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

        def body(i):
            for j in range(4):
                which = (i + j) % 3
                src, arr = (A, a) if (i + j) % 2 == 0 else (B, b)
                if which == 0:
                    (r,) = fm.materialize(fm.colMeans(src))
                    check(r, arr, "mean")
                elif which == 1:
                    r1, r2 = fm.batch(fm.colMeans(src), fm.colSums(src))
                    check(r1, arr, "mean")
                    check(r2, arr, "sum")
                else:
                    h = eng.submit(fm.colSums(src))
                    check(h.result(timeout=120), arr, "sum")

        try:
            errors = _threads_each(3, body, 300)
        finally:
            eng.close()
        assert not errors, errors


def test_flaky_group_leaves_no_partials_with_midstream_member():
    """A mid-stream-admitted member's future fails with the group's fault
    and registers nothing."""
    a = _x(8000, 8)
    for pkg in PKGS:
        fm = pkg.fm
        started, release = threading.Event(), threading.Event()

        class FlakyPaced(pkg.FlakyStore):
            def __init__(self, arr):
                super().__init__(arr, fail_after=-1)

            def block(self, start, stop):
                self.reads += 1
                if self.reads == 2:
                    started.set()
                    release.wait(timeout=30)
                if self.fail_after >= 0 and self.reads > self.fail_after:
                    raise StagingFault("injected fault after admission")
                return pkg.DenseStore.block(self, start, stop)

        st = FlakyPaced(a)
        X = pkg.FMMatrix(a.shape, a.dtype, store=st, name="flaky-paced")
        with fm.serve(window_ms=1, prefetch=False) as eng:
            h1 = eng.submit(fm.colMeans(X))
            assert started.wait(timeout=30)
            late = fm.colSums(X)
            h2 = eng.submit(late)
            st.fail_after = st.reads + 1   # fault a couple partitions later
            release.set()
            with pytest.raises(pkg.faults):
                h1.result(timeout=120)
            with pytest.raises(pkg.faults):
                h2.result(timeout=120)
        assert_no_partial_results(late.m.node)


# ---------------------------------------------------------------------------
# Submit backpressure: bounded pending queue
# ---------------------------------------------------------------------------

def test_submit_backpressure_rejects_when_saturated():
    """With the queue at max_pending_requests and submit_timeout_s=0, the
    next submit raises EngineSaturated, increments serve_rejections, and
    enqueues nothing."""
    a = _x(600, 4)
    for pkg in PKGS:
        fm = pkg.fm
        X = pkg.FMMatrix(a.shape, a.dtype, store=pkg.DenseStore(a),
                         name="bp")
        # A huge window holds every submit in the pending queue: depth is
        # deterministic, no scheduler race.
        eng = pkg.serve.Engine(window_ms=60_000, max_window_requests=None,
                               max_pending_requests=2, submit_timeout_s=0.0)
        try:
            eng.submit(fm.colMeans(X))
            eng.submit(fm.colSums(X))
            depth = pkg.metrics.REGISTRY.root.stats().get(
                "serve_queue_depth", {})
            assert depth.get("max", 0) >= 2, depth  # queue provably full
            with pytest.raises(pkg.serve.EngineSaturated):
                eng.submit(fm.colMaxs(X))
            assert eng.stats()["serve_rejections"] == 1
            with eng._cv:
                assert len(eng._pending) == 2  # rejected submit not enqueued
        finally:
            eng.close()


def test_submit_backpressure_blocks_until_window_drains():
    """A blocking submit (submit_timeout_s > 0) waits for the scheduler to
    swap the window out and then succeeds — no rejection counted."""
    a = _x(600, 4)
    for pkg in PKGS:
        fm = pkg.fm
        X = pkg.FMMatrix(a.shape, a.dtype, store=pkg.DenseStore(a),
                         name="bp2")
        eng = pkg.serve.Engine(window_ms=200, max_pending_requests=1,
                               submit_timeout_s=10.0)
        try:
            h1 = eng.submit(fm.colMeans(X))
            h2 = eng.submit(fm.colSums(X))  # blocks ~200ms for the drain
            assert np.allclose(_np(pkg, h1.result(60)), a.mean(0),
                               atol=1e-4)
            assert np.allclose(_np(pkg, h2.result(60)), a.sum(0),
                               atol=1e-3)
            assert eng.stats().get("serve_rejections", 0) == 0
        finally:
            eng.close()


def test_engine_saturated_reexported():
    for pkg in PKGS:
        assert pkg.fm.EngineSaturated is pkg.serve.EngineSaturated
        assert pkg.fm.Engine is pkg.serve.Engine
