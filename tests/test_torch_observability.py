"""Twin of tests/test_observability.py, the cells the prefetcher brings:
``test_collect_stats_isolates_concurrent_materializes`` (two threads, each
a prefetched stream from host RAM inside its own ``fm.collect_stats()``,
each scope seeing only its own counters, the staging thread's included)
and the two ``test_prefetch_error_*`` cells (a worker failure names the
partition's rows and the source).  Each runs in both packages on the same
numpy inputs.

``test_ooc_disk_scale_trace`` traces ``scale(X, save="disk")`` of an
``.fmat`` file in each package: the span tree and its counters agree.

The rest of the reference file comes with ROADMAP A10: the four tracer
tests, ``test_pass_bytes_scoped_per_execution_and_set_on_cache_hit``,
``test_exec_stats_compat_view`` and the four ``explain`` tests.
"""
import collections
import threading

import numpy as np
import pytest

from helpers_twin import (PORT, REF, _port_on_cpu, both_conf,  # noqa: F401
                          data_dirs, time_limit)
from repro import storage as jstorage
from repro_torch import storage as tstorage

pytestmark = pytest.mark.usefixtures("time_limit")

STORAGE = {REF.name: jstorage, PORT.name: tstorage}


def _arr(n=800, p=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)


@pytest.fixture()
def small_partitions():
    """Tiny I/O partitions so even small matrices stream multi-partition;
    both plan caches start and end empty."""
    with both_conf(io_partition_bytes=4096):
        REF.mz.clear_plan_cache()
        PORT.mz.clear_plan_cache()
        yield
    REF.mz.clear_plan_cache()
    PORT.mz.clear_plan_cache()


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_collect_stats_isolates_concurrent_materializes(small_partitions,
                                                        side):
    """Two threads materialize different matrices at once; each scope sees
    only its own counters — including the stage bytes recorded on each
    materialize's own prefetcher thread."""
    fm = side.fm
    a = _arr(n=2048, p=4, seed=1)
    b = _arr(n=4096, p=4, seed=2)
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def work(tag, arr):
        try:
            X = fm.conv_R2FM(arr, host=True)
            G = fm.crossprod(X)
            barrier.wait(timeout=30)
            with fm.collect_stats(tag) as scope:
                fm.materialize(G, mode="stream")
            results[tag] = scope.stats()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=("a", a)),
               threading.Thread(target=work, args=("b", b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a materialize hung"
    assert not errors, errors

    for tag, arr in (("a", a), ("b", b)):
        st = results[tag]
        assert st["materialize_calls"] == 1
        assert st["passes"] == 1
        assert st["pass_bytes_in"] == (arr.nbytes,)
        # Prefetch-thread staging attributed to the right scope.
        assert st["stage_bytes_read"] == arr.nbytes
    # b is twice as many rows as a: twice the partition steps, per scope.
    assert results["a"]["partition_steps"] > 1
    assert results["b"]["partition_steps"] == \
        2 * results["a"]["partition_steps"]
    assert STORAGE[side.name].live_prefetchers() == []


def test_collect_stats_counts_equal_across_packages(small_partitions):
    """The scoped counters of one prefetched stream, the reference's and
    the port's, are equal."""
    a = _arr(n=2048, p=4, seed=1)
    got = []
    for side in (REF, PORT):
        X = side.fm.conv_R2FM(a, host=True)
        with side.fm.collect_stats("one") as scope:
            side.fm.materialize(side.fm.crossprod(X), mode="stream")
        st = scope.stats()
        got.append({k: st[k] for k in ("materialize_calls", "passes",
                                       "partition_steps", "pass_bytes_in",
                                       "stage_bytes_read", "streams",
                                       "bytes_streamed")})
    assert got[1] == got[0]


def test_prefetch_error_carries_partition_and_source():
    class Exploding:
        name = "bad_matrix"

        def block(self, start, stop):
            raise OSError("bad sector")

    for side in (REF, PORT):
        storage = STORAGE[side.name]
        pf = storage.PartitionPrefetcher([(0, Exploding())], 8, 64)
        with pytest.raises(storage.PrefetchError,
                           match=r"rows \[0, 8\) of source 'bad_matrix'"):
            for _ in pf:
                pass
        pf.close()


def test_prefetch_error_names_unnamed_source_by_type():
    class Nameless:
        def block(self, start, stop):
            raise ValueError("boom")

    msgs = []
    for side in (REF, PORT):
        storage = STORAGE[side.name]
        pf = storage.PartitionPrefetcher([(0, Nameless())], 4, 8)
        with pytest.raises(storage.PrefetchError,
                           match=r"source 'Nameless'") as info:
            for _ in pf:
                pass
        pf.close()
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_ooc_disk_scale_trace(data_dirs, small_partitions, side):
    """scale(X, save='disk') over an ``.fmat`` file, traced: one
    materialize span, a pass span a pass (2), a partition span a step, the
    staging spans on the prefetcher's own track, one epilogue span, and
    every partition inside a pass and every step and combine inside a
    partition."""
    from repro.observability.trace import TRACER as JTRACER
    from repro_torch.observability.trace import TRACER as TTRACER
    fm = side.fm
    tracer = TTRACER if side is PORT else JTRACER
    a = _arr(n=1024, p=4, seed=3)
    X = fm.load_dense_matrix(a, "trace_x")
    Z = fm.scale(X, save="disk")
    fm.reset_exec_stats()
    with fm.trace():
        (Zm,) = fm.materialize(Z)
    st = fm.exec_stats()
    evs = fm.trace_events()
    counts = collections.Counter(e["name"] for e in evs)
    assert Zm.m.on_disk
    assert counts["materialize"] == 1
    assert counts["pass"] == st["passes"] == 2
    assert counts["partition"] == st["partition_steps"] > 2
    for required in ("stage", "prefetch_wait", "device_step", "combine"):
        assert counts[required] > 0, required
    assert counts["epilogue"] == st["epilogue_launches"] == 1
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    main_tid = threading.get_ident()
    assert main_tid not in {e["tid"] for e in by_name["stage"]}
    assert any(m.get("args", {}).get("name") == "fm-prefetch"
               for m in tracer.chrome_trace()["traceEvents"]
               if m["ph"] == "M")
    passes = [(p["ts"], p["ts"] + p["dur"]) for p in by_name["pass"]]
    for part in by_name["partition"]:
        lo, hi = part["ts"], part["ts"] + part["dur"]
        assert any(p0 <= lo and hi <= p1 for p0, p1 in passes)
    parts = [(p["ts"], p["ts"] + p["dur"]) for p in by_name["partition"]]
    for name in ("device_step", "combine"):
        for e in by_name[name]:
            lo, hi = e["ts"], e["ts"] + e["dur"]
            assert any(p0 <= lo and hi <= p1 for p0, p1 in parts), name
    tracer.reset()
