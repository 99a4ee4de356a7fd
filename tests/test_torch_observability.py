"""Twin of tests/test_observability.py, the cells the prefetcher brings:
``test_collect_stats_isolates_concurrent_materializes`` (two threads, each
a prefetched stream from host RAM inside its own ``fm.collect_stats()``,
each scope seeing only its own counters, the staging thread's included)
and the two ``test_prefetch_error_*`` cells (a worker failure names the
partition's rows and the source).  Each runs in both packages on the same
numpy inputs.

``test_ooc_disk_scale_trace`` traces ``scale(X, save="disk")`` of an
``.fmat`` file in each package: the span tree and its counters agree.

The device-tier cells: the four tracer tests, run on each package's own
tracer; ``test_pass_bytes_scoped_per_execution_and_set_on_cache_hit`` and
``test_exec_stats_compat_view`` in both packages, their counters equal;
and the four ``explain`` tests — the golden text of the two-pass
``scale(X)`` plan equal, character for character, to the reference's
golden (and to the reference's own output) under the name map
``EXPLAIN_NAME_MAP``: ``backend=xla`` → ``backend=torch``, ``xla generic
trace`` → ``torch generic rules``, ``pallas:`` → ``cuda:``, ``generic
trace (`` → ``generic rules (``.
"""
import collections
import importlib.util
import json
import pathlib
import re
import sys
import threading
from importlib import import_module

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


# ---------------------------------------------------------------------------
# Span tracer (each package's own)
# ---------------------------------------------------------------------------

def _tracer(side):
    return import_module(f"{side.name}.observability.trace").TRACER


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_span_nesting_and_containment(side):
    tracer = _tracer(side)
    tracer.start()
    with tracer.span("outer", idx=1):
        with tracer.span("inner"):
            pass
        with tracer.span("inner"):
            pass
    tracer.stop()
    evs = tracer.events()
    # Spans record on exit, so both children precede their parent.
    assert [e["name"] for e in evs] == ["inner", "inner", "outer"]
    outer = evs[-1]
    assert outer["args"] == {"idx": 1}
    for inner in evs[:2]:
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    tracer.reset()


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_disabled_tracer_records_nothing(side):
    tracer = _tracer(side)
    tracer.reset()
    with tracer.span("x", a=1):
        pass
    tracer.record("y", 0.0, 1.0)
    assert tracer.events() == []
    # Disabled spans are one shared null object — no per-span allocation.
    assert tracer.span("x") is tracer.span("y")


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_chrome_trace_export(side, tmp_path):
    fm, tracer = side.fm, _tracer(side)
    with fm.trace():
        with tracer.span("work", rows=7):
            pass
    path = tmp_path / "trace.json"
    fm.trace_export(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert [e["name"] for e in complete] == ["work"]
    assert complete[0]["dur"] >= 0 and complete[0]["args"] == {"rows": 7}
    assert any(m["name"] == "thread_name" for m in meta)
    assert any(m["name"] == "process_name" for m in meta)


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_trace_context_manager_resets_by_default(side):
    fm, tracer = side.fm, _tracer(side)
    with fm.trace():
        with tracer.span("first"):
            pass
    assert [e["name"] for e in fm.trace_events()] == ["first"]
    with fm.trace():
        pass
    assert fm.trace_events() == []          # reset=True dropped "first"
    assert not tracer.enabled               # and the tracer is off again


# ---------------------------------------------------------------------------
# Scoped metrics: per-execution pass bytes, the exec_stats view
# ---------------------------------------------------------------------------

def _metrics(side):
    return import_module(f"{side.name}.observability.metrics")


def test_pass_bytes_scoped_per_execution_and_set_on_cache_hit():
    a = _arr(n=128)
    got = []
    for side in (REF, PORT):
        fm, mz = side.fm, side.mz
        mz.reset_exec_stats()
        mz.clear_plan_cache()
        X = fm.conv_R2FM(a)
        fm.materialize(fm.crossprod(X))
        assert mz.exec_stats()["pass_bytes_in"] == (a.nbytes,)
        # Re-executing the cached plan must still publish its own bytes.
        with fm.collect_stats() as scope:
            fm.materialize(fm.crossprod(X))
        assert scope.stats()["pass_bytes_in"] == (a.nbytes,)
        st = mz.exec_stats()
        assert st["plan_cache_hits"] == 1 and st["plan_cache_misses"] == 1
        assert _metrics(side).stats()["plan_cache_hit_ratio"] == 0.5
        got.append(st)
    assert got[1] == got[0]


def test_exec_stats_compat_view():
    a = _arr(n=200)
    got = []
    for side in (REF, PORT):
        fm, mz = side.fm, side.mz
        mz.reset_exec_stats()
        mz.clear_plan_cache()
        X = fm.conv_R2FM(a)
        fm.materialize(fm.scale(X))
        st = mz.exec_stats()
        assert st["materialize_calls"] == 1
        assert st["passes"] == 2                 # scale is the two-pass plan
        assert st["epilogue_launches"] >= 1
        assert len(st["pass_bytes_in"]) == 2
        for key in mz.EXEC_COUNTERS:
            assert isinstance(st[key], int), key
        # The registry view carries the derived telemetry too.
        full = _metrics(side).stats()
        assert 0.0 <= full["prefetch_wait_frac"] <= 1.0
        assert full["stream_bandwidth_bytes_s"] >= 0.0
        got.append(st)
    assert got[1] == got[0]
    assert PORT.mz.EXEC_COUNTERS == REF.mz.EXEC_COUNTERS


# ---------------------------------------------------------------------------
# fm.explain (golden, under the name map)
# ---------------------------------------------------------------------------

_SPEC = importlib.util.spec_from_file_location(
    "_reference_observability",
    pathlib.Path(__file__).with_name("test_observability.py"))
_ref_obs = importlib.util.module_from_spec(_SPEC)
sys.modules[_SPEC.name] = _ref_obs
_SPEC.loader.exec_module(_ref_obs)

#: The reference's words → the port's, applied in this order to the
#: reference's explain text; no other character may differ.
EXPLAIN_NAME_MAP = (("backend=xla", "backend=torch"),
                    ("xla generic trace", "torch generic rules"),
                    ("pallas:", "cuda:"),
                    ("generic trace (", "generic rules ("))


def _port_words(text: str) -> str:
    for old, new in EXPLAIN_NAME_MAP:
        text = text.replace(old, new)
    return text


def test_explain_golden_two_pass_scale():
    texts = {}
    with both_conf(io_partition_bytes=1 << 20, vmem_partition_bytes=1 << 20):
        for side, backend in ((REF, "xla"), (PORT, "torch")):
            X = side.fm.conv_R2FM(np.ones((100, 3), np.float32))
            texts[side.name] = re.sub(
                r"#\d+", "#N", side.fm.explain(side.fm.scale(X),
                                               backend=backend))
    assert texts[REF.name] == _ref_obs.EXPLAIN_GOLDEN
    assert texts[PORT.name] == _port_words(_ref_obs.EXPLAIN_GOLDEN)


def test_explain_pallas_dispatch_reasons():
    a = _arr(n=256)
    texts = {}
    for side, backend in ((REF, "pallas"), (PORT, "cuda")):
        X = side.fm.conv_R2FM(a)
        texts[side.name] = re.sub(r"#\d+", "#N", side.fm.explain(
            side.fm.crossprod(X), backend=backend))
    assert "cuda:gram (claimed by " in texts[PORT.name]
    assert "backend=cuda" in texts[PORT.name]
    assert texts[PORT.name] == _port_words(texts[REF.name]).replace(
        "backend=pallas", "backend=cuda")


@pytest.mark.parametrize("side", [REF, PORT], ids=lambda s: s.name)
def test_explain_nothing_virtual(side):
    X = side.fm.conv_R2FM(_arr(n=16))
    assert "already materialized" in side.fm.explain(X)


@pytest.mark.parametrize("side,backend", [(REF, "xla"), (PORT, "torch")],
                         ids=["repro", "repro_torch"])
def test_plan_explain_method_matches_fm_explain(side, backend):
    X = side.fm.conv_R2FM(_arr(n=64))
    Z = side.fm.scale(X)
    assert side.Plan([Z.m]).explain(backend=backend) == side.fm.explain(
        Z, backend=backend)
