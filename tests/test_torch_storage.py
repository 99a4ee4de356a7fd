"""Twin of the prefetcher cells of tests/test_storage.py: the port's
``storage.PartitionPrefetcher`` held against the JAX package's on the same
numpy inputs, a host-tier ``DenseStore`` standing in for the reference's
``.fmat`` store (the disk tier is ROADMAP A7b), on the CPU engine device:
the same worker thread and bounded queue as on a card, staging plain CPU
tensors (tests/test_torch_cuda.py holds the pinned ring and the side CUDA
stream on the card).

The cells: ``test_prefetcher_ordering``, ``test_prefetcher_shutdown_midstream``,
``test_prefetcher_error_propagates``,
``test_interrupted_stream_leaks_no_prefetcher_state`` (over a host matrix),
``test_abandoned_prefetcher_close_drains_late_enqueue`` and
``negotiate_depth``'s table against the reference's function; then
``stage_block``'s host ELL branch and the executor's prefetched ``ooc`` /
``auto`` runs over a host dense matrix and a host ELL slab from
``fm.one_hot``'s default, with the plan counters and kernel dispatch equal
to the reference's exactly (``helpers_twin.both``, the prefetcher on in
both packages) and the values equal to the port's synchronous run bit for
bit.

Waiting for the disk tier (A7b): the format, ``MmapStore``, registry,
spill and ingest cells of tests/test_storage.py (``test_header_roundtrip``,
``test_mmap_block_equals_slice``, ``test_registry_roundtrip``,
``test_spill_kmeans_equals_in_memory``, ``test_ooc_correlation_from_disk``,
the ``direct_io`` and atexit-cleanup cells and the rest of its 31 tests).
"""
import threading
import time

import numpy as np
import pytest

from helpers_cache import StagingFault
from helpers_twin import (PORT, REF, _port_on_cpu, both,  # noqa: F401
                          both_conf, counting)
from helpers_twin import time_limit  # noqa: F401
from repro import storage as jstorage
from repro.core.matrix import DenseStore as JDenseStore
from repro_torch import storage as tstorage
from repro_torch.core import materialize as tmz
from repro_torch.core.matrix import DenseStore as TDenseStore
from repro_torch.core.matrix import FMMatrix as TFMMatrix
from repro_torch.core.sparse import SparseBlock as TSparseBlock

pytestmark = pytest.mark.usefixtures("time_limit")

STORAGE = {REF.name: (jstorage, JDenseStore), PORT.name: (tstorage,
                                                          TDenseStore)}


def _arr(n=1000, p=7, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, p)) * 3
            ).astype(np.float32)


def _np(block):
    return block.numpy() if hasattr(block, "numpy") else np.asarray(block)


def _wait_no_threads(storage, n_threads0, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and (
            storage.live_prefetchers()
            or threading.active_count() > n_threads0):
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# The prefetcher alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage_to_device", [False, True])
def test_prefetcher_ordering(stage_to_device):
    """Every partition, exactly once, in order, each block equal to the
    store's rows — the same sequence in both packages."""
    A = _arr(1000, 5)
    B = _arr(1000, 3, seed=1)
    seqs = []
    for side in (REF, PORT):
        storage, Store = STORAGE[side.name]
        with storage.PartitionPrefetcher(
                [(0, Store(A)), (1, Store(B))], 128, 1000,
                stage_to_device=stage_to_device) as pf:
            seen = []
            for start, stop, blocks in pf:
                seen.append((start, stop))
                np.testing.assert_array_equal(_np(blocks[0]), A[start:stop])
                np.testing.assert_array_equal(_np(blocks[1]), B[start:stop])
        seqs.append(seen)
    assert seqs[1] == seqs[0] == [(s, min(s + 128, 1000))
                                  for s in range(0, 1000, 128)]


def test_prefetcher_shutdown_midstream():
    A = _arr(10_000, 4)
    for side in (REF, PORT):
        storage, Store = STORAGE[side.name]
        pf = storage.PartitionPrefetcher([(0, Store(A))], 64, 10_000,
                                         stage_to_device=False)
        for i, _ in enumerate(pf):
            if i == 2:
                break  # abandon with ~150 partitions outstanding
        pf.close()
        assert not pf.alive
        pf.close()  # idempotent
        assert pf.queued == 0


def test_prefetcher_error_propagates():
    class Exploding:
        def block(self, start, stop):
            raise OSError("bad sector")

    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        pf = storage.PartitionPrefetcher([(0, Exploding())], 8, 64)
        with pytest.raises(storage.PrefetchError, match="bad sector"):
            for _ in pf:
                pass
        pf.close()
        assert not pf.alive


def test_prefetcher_row_start_and_reuse():
    """``row_start`` begins the range mid-matrix (one prefetcher a shard);
    ``reuse`` serves the final partition from the given block, counted as
    a reuse hit, in both packages."""
    A = _arr(300, 2)
    got = []
    for side in (REF, PORT):
        storage, Store = STORAGE[side.name]
        final = A[256:300] * 0  # a marker: served, never read from A
        with counting(side, ("prefetch_reuse_hits",)) as c:
            with storage.PartitionPrefetcher(
                    [(7, Store(A))], 64, 300, row_start=128,
                    stage_to_device=False, reuse={7: final}) as pf:
                parts = [(s, e, _np(b[7])) for s, e, b in pf]
        assert [(s, e) for s, e, _ in parts] == [(128, 192), (192, 256),
                                                 (256, 300)]
        np.testing.assert_array_equal(parts[0][2], A[128:192])
        np.testing.assert_array_equal(parts[-1][2], final)
        got.append(c)
    assert got[1] == got[0] == {"prefetch_reuse_hits": 1}


@pytest.mark.parametrize("n_members,nbytes,base,budget", [
    (1, 1 << 20, 2, None), (4, 1 << 20, 2, None), (32, 1 << 20, 2, None),
    (4, 1 << 20, 2, 3 << 20), (4, 8 << 20, 2, 4 << 20), (1, 1 << 20, 1, None),
    (3, 0, 5, 1 << 20), (2, 1 << 20, None, None)])
def test_negotiate_depth_matches_the_reference(n_members, nbytes, base,
                                               budget):
    """The group-aware depth, the reference's table: +1 a member, capped at
    8 and at the staging budget, never below 1; ``base`` None reads the
    ``prefetch_depth`` knob in each package."""
    with both_conf(prefetch_depth=3):
        want = jstorage.negotiate_depth(n_members, nbytes, base=base,
                                        budget_bytes=budget)
        got = tstorage.negotiate_depth(n_members, nbytes, base=base,
                                       budget_bytes=budget)
    assert got == want
    assert tstorage.prefetch.MAX_NEGOTIATED_DEPTH == \
        jstorage.prefetch.MAX_NEGOTIATED_DEPTH


# ---------------------------------------------------------------------------
# Shutdown on interrupted streams
# ---------------------------------------------------------------------------

def test_interrupted_stream_leaks_no_prefetcher_state():
    """A staging fault mid-stream tears the prefetch pipeline down
    completely in both packages: worker thread joined, queued partitions
    drained, TLS residents cleared — thread count and the staged-partition
    census back to baseline."""
    A = _arr(4096, 4)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        fm = side.fm
        with fm.conf(io_partition_bytes=4096):
            X = fm.persist(fm.conv_R2FM(A), tier="host")
            store = X.m.store
            orig_block, reads = store.block, {"n": 0}

            def flaky_block(start, stop):
                reads["n"] += 1
                if reads["n"] > 2:
                    raise StagingFault("injected host fault")
                return orig_block(start, stop)

            store.block = flaky_block  # instance attr shadows the method
            n_threads0 = threading.active_count()
            with pytest.raises(storage.PrefetchError,
                               match="injected host fault"):
                fm.materialize(fm.colSums(X * X), mode="ooc",
                               prefetch=True)
        _wait_no_threads(storage, n_threads0)
        assert storage.live_prefetchers() == [], "worker thread still alive"
        assert storage.staged_leaks() == [], "staged partitions queued"
        assert threading.active_count() <= n_threads0
        assert side.mz._tls_residents() is None
        side.mz.clear_plan_cache()


def test_abandoned_prefetcher_close_drains_late_enqueue():
    """close() wins the race against a worker parked in the bounded
    queue's put(): abandon a stream mid-flight with a FULL queue, ten
    times, and no staged block survives shutdown."""
    A = _arr(4096, 4)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        X = side.fm.persist(side.fm.conv_R2FM(A), tier="host")
        pairs = [(0, X.m)]
        for _ in range(10):
            pf = storage.PartitionPrefetcher(pairs, 256, 4096, depth=1)
            it = iter(pf)
            next(it)          # worker now racing to refill the full queue
            pf.close()
            assert not pf.alive
            assert pf.queued == 0, "block enqueued after shutdown drain"
        assert storage.staged_leaks() == []


def test_fault_in_a_prefetched_pass_registers_nothing_and_names_the_rows():
    """A fault in the staging thread reaches ``materialize`` as
    PrefetchError naming the rows and the source, registers no result and
    leaves no ``fm-prefetch`` thread, staged partition or resident."""
    from helpers_cache import assert_no_partial_results
    from helpers_twin import FlakyStore
    from repro_torch.core import dag as tdag
    A = _arr(800, 4)
    store = FlakyStore(A, 3)
    X = TFMMatrix(A.shape, A.dtype, store=store, name="flaky_x")
    Z = PORT.fm.scale(PORT.fm.FM(X))
    nodes = tdag.toposort([Z.m.node])
    with PORT.fm.conf(io_partition_bytes=4096):
        with tmz.iteration_scope():
            with pytest.raises(tstorage.PrefetchError,
                               match=r"rows \[\d+, \d+\) of source "
                                     r"'flaky_x'"):
                PORT.fm.materialize(Z)
            assert tmz._tls_residents() is None
    assert_no_partial_results(*nodes)
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "fm-prefetch" for t in threading.enumerate()):
        time.sleep(0.02)
    assert not any(t.name == "fm-prefetch" for t in threading.enumerate())
    assert tstorage.live_prefetchers() == []
    assert tstorage.staged_leaks() == []


# ---------------------------------------------------------------------------
# stage_block's host ELL branch
# ---------------------------------------------------------------------------

def test_stage_block_host_ell_leafwise():
    """A host slab's partition is staged leaf by leaf: both leaves made
    contiguous (their bytes counted as the host read, as in the
    reference), then tensors on the engine's device; a device slab's block
    passes through."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, 300)
    got = []
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        X = side.fm.one_hot(side.fm.as_factor(codes, 5))
        assert X.m.is_sparse and X.m.on_host
        with counting(side, ("stage_bytes_read",)) as c:
            blk = storage.prefetch.stage_block(X.m, 40, 104)
        got.append(c)
        np.testing.assert_array_equal(_np(blk.cols).ravel(), codes[40:104])
        np.testing.assert_array_equal(_np(blk.vals), np.ones((64, 1)))
    assert got[1] == got[0] == {"stage_bytes_read": 64 * 8}
    assert isinstance(blk, TSparseBlock) and not isinstance(blk.cols,
                                                            np.ndarray)
    D = PORT.fm.one_hot(PORT.fm.as_factor(codes, 5), host=False)
    dblk = tstorage.prefetch.stage_block(D.m, 0, 10)
    assert dblk.cols.data_ptr() == D.m.store.cols.data_ptr()


# ---------------------------------------------------------------------------
# The executor's prefetched streams against the reference
# ---------------------------------------------------------------------------

def _dense_host(fm):
    A = _arr(900, 5, seed=11)
    return fm.conv_R2FM(A, host=True)


def _ell_host(fm):
    rng = np.random.default_rng(12)
    return fm.one_hot(fm.as_factor(rng.integers(0, 6, 900), 6),
                      fm.as_factor(rng.integers(0, 4, 900), 4))


_PROGRAMS = {
    "crossprod": lambda fm, X: [fm.crossprod(X)],
    "sinks": lambda fm, X: [fm.colSums(X), fm.crossprod(X * 2.0)],
    "rowlocal": lambda fm, X: [X * 3.0 - 1.0, fm.colSums(X)],
    "two_pass": lambda fm, X: [fm.crossprod(X - fm.colMeans(X))],
}


@pytest.mark.parametrize("mode", ["ooc", "auto"])
@pytest.mark.parametrize("source", ["dense", "ell"])
@pytest.mark.parametrize("program", sorted(_PROGRAMS))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefetched_host_streams_equal_the_reference(backend, program,
                                                     source, mode):
    """``ooc`` / ``auto`` over a host dense matrix and over a host ELL slab
    from ``fm.one_hot``'s default, the prefetcher on (the conf default) in
    both packages: counters — passes, bytes in, partition steps, streams,
    bytes streamed, epilogue launches, host bytes read, reuse hits — and
    the kernel dispatch equal the reference's exactly, the values its
    within 1e-5; and the port's values equal its synchronous run's bit for
    bit."""
    make = _dense_host if source == "dense" else _ell_host
    prog = _PROGRAMS[program]

    def run(fm):
        return prog(fm, make(fm))

    with both_conf(io_partition_bytes=4096):
        ref, port = both(run, backend=backend, mode=mode)
        sync = [PORT.fm.as_np(o) for o in PORT.fm.materialize(
            *run(PORT.fm), mode=mode, backend=backend, prefetch=False)]
        st = PORT.mz.exec_stats()
    assert st["partition_steps"] > st["passes"]  # many partitions a pass
    for r, t, s in zip(ref, port, sync, strict=True):
        np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t, s)
