"""Twin of tests/test_storage.py: the port's storage tier held against the
JAX package's on the same numpy inputs, on the CPU engine device (the same
prefetcher thread and bounded queue as on a card, staging plain CPU
tensors; tests/test_torch_cuda.py holds the pinned ring and the side CUDA
stream on the card).

The prefetcher's cells over a host-tier ``DenseStore``:
``test_prefetcher_ordering``, ``test_prefetcher_shutdown_midstream``,
``test_prefetcher_error_propagates``,
``test_interrupted_stream_leaks_no_prefetcher_state``,
``test_abandoned_prefetcher_close_drains_late_enqueue`` and
``negotiate_depth``'s table; ``stage_block``'s host ELL branch and the
executor's prefetched ``ooc`` / ``auto`` runs over a host dense matrix and
a host ELL slab, with the plan counters and kernel dispatch equal to the
reference's exactly (``helpers_twin.both``) and the values equal to the
port's synchronous run bit for bit.

The disk tier: the ``.fmat`` format (``test_header_roundtrip``, the bad
magic, vectors), ``MmapStore`` (blocks in both layouts, the zero-copy
transpose, ``write_rows``), the files each package writes byte for byte
equal and read by the other (``test_fmat_files_cross_packages``), the
registry, ``persist(tier="disk")`` and ingest, ``ooc`` correlation and
k-means from disk, ``direct_io``, staging dedupe, ``save='disk'`` spills,
the plan cache over disk sources and the registry's owned temp dirs; then
one test a place where the disk tier meets the port: a memmap block read
into host memory by ``stage_block`` itself, the file's dtypes staged in
their canonical types, bfloat16 in each package, ``drop_cache``'s ranges
and the lifetime of views past ``close()``; ``test_plan_cache_mesh_key_not_id``
over a one-device mesh in each package.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from helpers_cache import StagingFault
from helpers_twin import (PORT, REF, _port_on_cpu, both,  # noqa: F401
                          both_conf, counting, data_dirs, save_both)
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


# ---------------------------------------------------------------------------
# The disk tier: the .fmat format and MmapStore
# ---------------------------------------------------------------------------

DTYPES = [np.float32, np.float64, np.int32]


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_header_roundtrip(tmp_path, layout, dtype):
    A = _arr().astype(dtype)
    headers = []
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        path = tmp_path / f"{side.name}.fmat"
        written = storage.save_matrix(path, A, layout=layout)
        header = storage.read_header(path)
        assert header == written
        assert header.shape == A.shape
        assert header.dtype == np.dtype(dtype)
        assert header.layout == layout
        assert header.body_offset % 4096 == 0
        st = storage.open_matrix(path)
        np.testing.assert_array_equal(np.asarray(st.logical()), A)
        headers.append(dataclasses.astuple(header))
    assert headers[1] == headers[0]


def test_bad_magic_rejected(tmp_path):
    path = tmp_path / "junk.fmat"
    path.write_bytes(b"NOTAMATRIX" * 10)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        with pytest.raises(ValueError, match="magic"):
            storage.read_header(path)
        with pytest.raises(ValueError, match="magic"):
            storage.peek_format(path)


def test_vector_becomes_one_column(tmp_path):
    v = np.arange(10, dtype=np.float32)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        storage.save_matrix(tmp_path / f"{side.name}.fmat", v)
        st = storage.open_matrix(tmp_path / f"{side.name}.fmat")
        assert st.header.shape == (10, 1)
    # a tensor (any device) goes to host memory first
    tstorage.save_matrix(tmp_path / "t.fmat", torch.from_numpy(v))
    st = tstorage.open_matrix(tmp_path / "t.fmat")
    assert st.header.shape == (10, 1)
    np.testing.assert_array_equal(st.logical().ravel(), v)


@pytest.mark.parametrize("layout", ["row", "col"])
def test_mmap_block_matches_memory(tmp_path, layout):
    A = _arr(500, 6)
    stores = []
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        storage.save_matrix(tmp_path / f"{side.name}.fmat", A, layout=layout)
        stores.append(storage.open_matrix(tmp_path / f"{side.name}.fmat"))
    jst, st = stores
    for start, stop in [(0, 500), (0, 1), (7, 130), (499, 500), (128, 256)]:
        np.testing.assert_array_equal(np.asarray(st.block(start, stop)),
                                      A[start:stop])
        np.testing.assert_array_equal(np.asarray(st.block(start, stop)),
                                      np.asarray(jst.block(start, stop)))
    assert st.nbytes() == A.nbytes == jst.nbytes()
    assert st.on_host and st.on_disk


def test_mmap_transpose_zero_copy(tmp_path):
    A = _arr(64, 5)
    tstorage.save_matrix(tmp_path / "a.fmat", A)
    st = tstorage.open_matrix(tmp_path / "a.fmat")
    mat = TFMMatrix(A.shape, A.dtype, store=st)
    t = mat.transpose()
    assert t.shape == (5, 64)
    assert t.store.on_disk and t.store._mm is st._mm  # the same mapping
    np.testing.assert_array_equal(np.asarray(t.block(1, 3)), A.T[1:3])


def test_write_rows_roundtrip(tmp_path):
    A = _arr(200, 4)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        path = tmp_path / f"{side.name}.fmat"
        st = storage.create_matrix(path, A.shape, A.dtype)
        for start in range(0, 200, 64):
            st.write_rows(start, A[start:start + 64])
        st.flush()
        reopened = storage.open_matrix(path)
        np.testing.assert_array_equal(np.asarray(reopened.logical()), A)
        with pytest.raises(ValueError, match="read-only"):
            reopened.write_rows(0, A[:1])
    assert (tmp_path / "repro.fmat").read_bytes() == \
        (tmp_path / "repro_torch.fmat").read_bytes()


def test_fmat_files_cross_packages(tmp_path):
    """Byte compatibility: for the same numpy input both packages write
    identical dense files (f32 / f64 / int32, row and col) and identical
    CSR files, and each package opens the other's files to equal blocks."""
    from repro.core.sparse import csr_from_dense
    rng = np.random.default_rng(4)
    for dtype in DTYPES:
        for layout in ("row", "col"):
            A = (rng.normal(size=(300, 5)) * 50).astype(dtype)
            paths = {}
            for side in (REF, PORT):
                storage, _ = STORAGE[side.name]
                paths[side.name] = tmp_path / f"{side.name}-{layout}.fmat"
                storage.save_matrix(paths[side.name], A, layout=layout,
                                    chunk_rows=64)
            assert paths["repro"].read_bytes() == \
                paths["repro_torch"].read_bytes(), (dtype, layout)
            for side, other in ((REF, "repro_torch"), (PORT, "repro")):
                storage, _ = STORAGE[side.name]
                st = storage.open_matrix(paths[other])
                assert st.layout == layout and st.header.shape == A.shape
                np.testing.assert_array_equal(np.asarray(st.block(17, 140)),
                                              A[17:140])
    dense = rng.normal(size=(97, 13)).astype(np.float32)
    dense *= rng.random(dense.shape) < 0.3
    dense[5] = 0.0
    triplet = csr_from_dense(dense)
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        storage.save_csr_matrix(tmp_path / f"{side.name}.csr.fmat", *triplet,
                                ncol=13)
    assert (tmp_path / "repro.csr.fmat").read_bytes() == \
        (tmp_path / "repro_torch.csr.fmat").read_bytes()
    for side, other in ((REF, "repro_torch"), (PORT, "repro")):
        storage, _ = STORAGE[side.name]
        st = storage.open_matrix(tmp_path / f"{other}.csr.fmat")
        assert st.sparse and st.shape == (97, 13)
        blk = st.block(3, 60)
        np.testing.assert_array_equal(np.asarray(blk.todense()), dense[3:60])
        assert st.nbytes() == 98 * 8 + int(triplet[0][-1]) * 8


def test_dense_store_col_layout_block():
    """A col-layout host block slices the stored buffer and transposes
    only the block."""
    A = _arr(100, 3)
    st = TDenseStore(np.ascontiguousarray(A.T), "col")
    np.testing.assert_array_equal(np.asarray(st.block(10, 20)), A[10:20])
    blk = st.block(10, 20)
    assert blk.base is st.data or blk.base is getattr(st.data, "base", None)


# ---------------------------------------------------------------------------
# The disk tier through the engine, against the reference
# ---------------------------------------------------------------------------

def test_registry_roundtrip(data_dirs):
    A = _arr()
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        fm = side.fm
        fm.load_dense_matrix(A, "mat_a")
        assert "mat_a" in storage.list_matrices()
        Y = fm.get_dense_matrix("mat_a")
        assert Y.m.on_disk and Y.m.name == "mat_a"
        np.testing.assert_array_equal(fm.as_np(Y), A)
        with pytest.raises(KeyError):
            fm.get_dense_matrix("nope")
    assert (data_dirs["repro"] / "mat_a.fmat").read_bytes() == \
        (data_dirs["repro_torch"] / "mat_a.fmat").read_bytes()


def test_conv_store_disk(data_dirs):
    A = _arr()
    for side in (REF, PORT):
        fm = side.fm
        X = fm.conv_R2FM(A)
        Xd = fm.persist(X, tier="disk", name="spilled")
        assert Xd.m.on_disk
        np.testing.assert_array_equal(fm.as_np(Xd), A)
        np.testing.assert_array_equal(
            fm.as_np(fm.get_dense_matrix("spilled")), A)
    assert (data_dirs["repro"] / "spilled.fmat").read_bytes() == \
        (data_dirs["repro_torch"] / "spilled.fmat").read_bytes()


def test_ingest_csv_and_binary(data_dirs, tmp_path):
    A = _arr(300, 4)
    csv = tmp_path / "a.csv"
    np.savetxt(csv, A, delimiter=",", comments="", header="a,b,c,d")
    raw = tmp_path / "a.bin"
    A.tofile(raw)
    for side in (REF, PORT):
        fm = side.fm
        X = fm.load_dense_matrix(str(csv), "from_csv", skip_header=1,
                                 chunk_rows=64)
        np.testing.assert_allclose(fm.as_np(X), A, rtol=1e-6)
        Y = fm.load_dense_matrix(str(raw), "from_bin", ncol=4,
                                 chunk_rows=100)
        np.testing.assert_array_equal(fm.as_np(Y), A)
    for name in ("from_csv", "from_bin"):
        assert (data_dirs["repro"] / f"{name}.fmat").read_bytes() == \
            (data_dirs["repro_torch"] / f"{name}.fmat").read_bytes()


@pytest.mark.parametrize("prefetch", [True, False])
def test_ooc_disk_equals_memory_correlation(data_dirs, prefetch):
    from repro_torch.algorithms import correlation
    A = _arr(5000, 6)
    save_both(A, "corr")
    with both_conf(io_partition_bytes=1 << 14):
        with counting(PORT, ("passes", "partition_steps")) as st:
            ref, (G, s) = both(
                lambda f: [f.crossprod(f.get_dense_matrix("corr")),
                           f.colSums(f.get_dense_matrix("corr"))],
                mode="auto", prefetch=prefetch)
        Xm = PORT.fm.conv_R2FM(A)
        G2, s2 = PORT.fm.materialize(PORT.fm.crossprod(Xm),
                                     PORT.fm.colSums(Xm), mode="stream")
        c_disk = correlation(PORT.fm.get_dense_matrix("corr"))
    assert st["partition_steps"] > st["passes"] == 1
    np.testing.assert_allclose(G, PORT.fm.as_np(G2), rtol=1e-5)
    np.testing.assert_allclose(G, ref[0], rtol=1e-5)
    np.testing.assert_allclose(c_disk, correlation(Xm), rtol=1e-4, atol=1e-5)


def test_ooc_disk_equals_memory_kmeans(data_dirs):
    from repro.algorithms import kmeans as jkmeans
    from repro_torch.algorithms import kmeans
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(3, 5)) * 10
    A = np.concatenate(
        [c + rng.normal(size=(400, 5)) for c in centers]).astype(np.float32)
    save_both(A, "km")
    with both_conf(io_partition_bytes=1 << 13):
        r_disk = kmeans(PORT.fm.get_dense_matrix("km"), k=3, max_iter=10,
                        seed=1)
        r_mem = kmeans(PORT.fm.conv_R2FM(A), k=3, max_iter=10, seed=1,
                       mode="stream")
        r_ref = jkmeans(REF.fm.get_dense_matrix("km"), k=3, max_iter=10,
                        seed=1)
    np.testing.assert_allclose(r_disk.centers, r_mem.centers, atol=1e-5)
    assert abs(r_disk.wss - r_mem.wss) <= 1e-4 * max(1.0, abs(r_mem.wss))
    np.testing.assert_allclose(r_disk.centers, r_ref.centers, atol=1e-4)
    assert r_disk.iters == r_ref.iters


@pytest.mark.parametrize("layout", ["row", "col"])
def test_direct_io_reads_correct_and_cold(data_dirs, layout):
    """direct_io=True must not change results: blocks are copies read into
    host memory and the pages are dropped after the read (best-effort
    posix_fadvise DONTNEED); counters equal the reference's."""
    A = _arr(3000, 4)
    save_both(A, f"dio_{layout}", layout=layout)
    Xd = PORT.fm.get_dense_matrix(f"dio_{layout}")
    with both_conf(direct_io=True, io_partition_bytes=1 << 13):
        blk = Xd.m.store.block(100, 200)
        assert isinstance(blk, np.ndarray) and not isinstance(blk, np.memmap)
        np.testing.assert_array_equal(blk, A[100:200])
        ref, (G, s) = both(
            lambda f: [f.crossprod(f.get_dense_matrix(f"dio_{layout}")),
                       f.colSums(f.get_dense_matrix(f"dio_{layout}"))],
            mode="auto")
    np.testing.assert_allclose(
        G, A.T.astype(np.float64) @ A.astype(np.float64), rtol=1e-4)
    np.testing.assert_allclose(s.reshape(-1), A.sum(0), rtol=1e-4)
    # normal mode again serves lazy views
    blk2 = Xd.m.store.block(0, 10)
    assert isinstance(blk2, np.memmap)
    np.testing.assert_array_equal(np.asarray(blk2), A[:10])


def test_staging_dedupes_shared_matrix_reads(data_dirs):
    """A DAG referencing one physical matrix through k leaves reads each
    partition from the store once, not k times."""
    from repro_torch.core.fusion import Plan
    A = _arr(20_000, 4)
    fm = PORT.fm
    with fm.conf(io_partition_bytes=1 << 18):
        Xd = fm.load_dense_matrix(A, "dedupe")
        store = Xd.m.store
        reads = []
        orig_block = store.block
        store.block = lambda start, stop: (reads.append((start, stop)),
                                           orig_block(start, stop))[1]
        outs = (fm.crossprod(Xd), fm.colSums(Xd), fm.colSums(Xd ** 2))
        plan = Plan([o.m for o in outs])
        assert len(plan.sources) >= 3
        assert len(plan.source_groups) == 1
        Gm, sm, qm = fm.materialize(*outs, prefetch=False)
        n_partitions = -(-A.shape[0] // plan.partition_rows)
        assert len(reads) == n_partitions
    np.testing.assert_allclose(fm.as_np(Gm), A.T.astype(np.float64) @ A,
                               rtol=1e-4)
    np.testing.assert_allclose(fm.as_np(sm).reshape(-1), A.sum(0), rtol=1e-4)
    np.testing.assert_allclose(fm.as_np(qm).reshape(-1), (A * A).sum(0),
                               rtol=1e-4)


def _spilled(f, name, mode):
    Z = f.abs_(f.get_dense_matrix(name)) * 2.0 - 1.0
    f.persist(Z, tier="disk")
    return [Z]


@pytest.mark.parametrize("mode", ["auto", "stream", "whole"])
def test_spill_to_disk_output(data_dirs, mode):
    """save='disk' long-dimension outputs stream into an on-disk matrix
    (in one go in whole mode) and equal the in-memory result; the
    counters equal the reference's."""
    A = _arr(4000, 4)
    save_both(A, "base")
    with both_conf(io_partition_bytes=1 << 14):
        ref, (z,) = both(lambda f: _spilled(f, "base", mode), mode=mode)
        (Zm,) = PORT.fm.materialize(*_spilled(PORT.fm, "base", mode),
                                    mode=mode)
    assert Zm.m.on_disk and Zm.m.store.path.parent.name == "spill"
    np.testing.assert_allclose(z, np.abs(A) * 2.0 - 1.0, rtol=1e-6)
    np.testing.assert_array_equal(z, ref[0])
    # whole-mode spill of a device-resident computation
    W = PORT.fm.conv_R2FM(A)
    Z2 = PORT.fm.sqrt(PORT.fm.abs_(W))
    PORT.fm.persist(Z2, tier="disk")
    (Z2m,) = PORT.fm.materialize(Z2, mode="whole")
    assert Z2m.m.on_disk
    np.testing.assert_allclose(PORT.fm.as_np(Z2m), np.sqrt(np.abs(A)),
                               rtol=1e-6)


def test_disk_source_disk_sink_pipeline(data_dirs):
    """Disk in, disk out, nothing big in RAM; the named result equals the
    reference's file byte for byte."""
    A = _arr(3000, 3)
    for side in (REF, PORT):
        fm = side.fm
        with fm.conf(io_partition_bytes=1 << 13):
            Xd = fm.load_dense_matrix(A, "pipe_in")
            Z = (Xd - 1.0) / 2.0
            fm.persist(Z, tier="disk")
            (Zm,) = fm.materialize(Z)
            assert Zm.m.on_disk
            fm.persist(Zm, tier="disk", name="pipe_out")
        np.testing.assert_allclose(fm.as_np(fm.get_dense_matrix("pipe_out")),
                                   (A - 1.0) / 2.0, rtol=1e-6)
    assert (data_dirs["repro"] / "pipe_out.fmat").read_bytes() == \
        (data_dirs["repro_torch"] / "pipe_out.fmat").read_bytes()


# ---------------------------------------------------------------------------
# Plan cache over disk sources
# ---------------------------------------------------------------------------

def test_plan_cache_survives_mode_change(data_dirs):
    """A cached plan reused under another mode (ooc from disk, then whole
    on the device) skips no sink."""
    A = _arr(2000, 4)
    fm = PORT.fm
    Xd = fm.load_dense_matrix(A, "pc")
    (Gd,) = fm.materialize(fm.crossprod(Xd))          # ooc
    Xm = fm.conv_R2FM(A)
    (Gm,) = fm.materialize(fm.crossprod(Xm))          # whole, same signature
    expected = A.T.astype(np.float64) @ A.astype(np.float64)
    np.testing.assert_allclose(fm.as_np(Gd), expected, rtol=1e-4)
    np.testing.assert_allclose(fm.as_np(Gm), expected, rtol=1e-4)


def test_spill_to_disk_survives_plan_cache(data_dirs):
    """A cache-hit save='disk' materialization still spills (the first
    execution clears the template's save flags)."""
    A = _arr(2000, 3)
    fm = PORT.fm
    with counting(PORT, ("plan_cache_hits",)) as c:
        for i in range(3):
            Xd = fm.load_dense_matrix(A + i, f"sp{i}")
            Z = fm.abs_(Xd) * 2.0
            fm.persist(Z, tier="disk")
            (Zm,) = fm.materialize(Z)
            assert Zm.m.on_disk, f"round {i} lost the disk spill target"
            np.testing.assert_allclose(fm.as_np(Zm), np.abs(A + i) * 2.0,
                                       rtol=1e-6)
    assert PORT.mz.exec_stats()["plan_cache_hits"] >= 2


def test_partition_budget_change_misses_cache(data_dirs):
    """The partition budget is part of the plan-cache key."""
    A = _arr(100_000, 4)
    fm = PORT.fm
    Xd = fm.load_dense_matrix(A, "budget")
    fm.materialize(fm.colSums(Xd))
    assert len(PORT.mz._PLANS) == 1
    with fm.conf(io_partition_bytes=1 << 18):
        (s,) = fm.materialize(fm.colSums(fm.get_dense_matrix("budget")))
    assert len(PORT.mz._PLANS) == 2
    np.testing.assert_allclose(fm.as_np(s).reshape(-1), A.sum(0), rtol=1e-4)


def test_plan_cache_hit_preserves_first_dag(data_dirs):
    """Borrowing a cached plan does not clobber the first caller's
    persisted cut points."""
    fm = PORT.fm
    A = fm.conv_R2FM(np.full((64, 2), 2.0, np.float32))
    VA = A + 0.0
    fm.persist(VA, tier="device")
    VB = VA * 10.0
    fm.materialize(VA)
    VC = fm.conv_R2FM(np.full((64, 2), 5.0, np.float32)) + 0.0
    fm.persist(VC, tier="device")
    (VCm,) = fm.materialize(VC)
    np.testing.assert_allclose(fm.as_np(VCm), 5.0)
    (VBm,) = fm.materialize(VB)
    np.testing.assert_allclose(fm.as_np(VBm), 20.0)  # not 50.0


# ---------------------------------------------------------------------------
# Registry-owned temp dirs
# ---------------------------------------------------------------------------

def test_registry_cleanup_removes_owned_dirs_only(tmp_path, monkeypatch):
    """Lazily made fm-data-* dirs are removed by cleanup() and forgotten; a
    user-configured data_dir is never touched."""
    reg = tstorage.registry
    monkeypatch.setitem(reg._CONF, "data_dir", None)
    saved_owned = list(reg._OWNED_DIRS)
    reg._OWNED_DIRS[:] = []
    try:
        lazy = reg.data_dir()
        assert lazy.exists() and lazy.name.startswith("fm-data-")
        assert lazy in reg._OWNED_DIRS
        removed = tstorage.cleanup()
        assert lazy in removed
        assert not lazy.exists()
        assert reg._OWNED_DIRS == []
        assert reg._CONF["data_dir"] is None
        user = tmp_path / "user-data"
        PORT.fm.set_conf(data_dir=str(user))
        assert reg.data_dir() == user
        assert tstorage.cleanup() == []
        assert user.exists()
        assert reg._CONF["data_dir"] == user
    finally:
        reg._OWNED_DIRS[:] = saved_owned


def test_registry_data_dir_agrees_across_threads(monkeypatch):
    """Concurrent first touches of the disk tier agree on one directory."""
    reg = tstorage.registry
    monkeypatch.setitem(reg._CONF, "data_dir", None)
    saved_owned = list(reg._OWNED_DIRS)
    reg._OWNED_DIRS[:] = []
    got, barrier = [], threading.Barrier(8)

    def touch():
        barrier.wait()
        got.append(reg.data_dir())

    try:
        threads = [threading.Thread(target=touch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(set(got)) == 1 and reg._OWNED_DIRS == [got[0]]
    finally:
        tstorage.cleanup()
        reg._OWNED_DIRS[:] = saved_owned


def test_engine_close_release_storage(monkeypatch):
    """Engine.close(release_storage=True) routes to registry.cleanup()."""
    reg = tstorage.registry
    monkeypatch.setitem(reg._CONF, "data_dir", None)
    saved_owned = list(reg._OWNED_DIRS)
    reg._OWNED_DIRS[:] = []
    try:
        lazy = reg.data_dir()
        assert lazy.exists()
        eng = PORT.fm.serve(window_ms=1)
        eng.close(release_storage=True)
        assert not lazy.exists()
    finally:
        reg._OWNED_DIRS[:] = saved_owned


def test_registry_cleanup_runs_at_interpreter_exit():
    """The atexit hook removes a lazily made data dir when the process
    exits normally."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    code = ("import json\n"
            "from repro_torch.storage import registry\n"
            "d = registry.data_dir()\n"
            "assert d.exists()\n"
            "print(json.dumps(str(d)))\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    leaked = pathlib.Path(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not leaked.exists(), f"atexit cleanup left {leaked}"


# ---------------------------------------------------------------------------
# Where the disk tier meets the port (one test a trouble spot)
# ---------------------------------------------------------------------------

def test_stage_block_reads_a_disk_block_into_host_memory(data_dirs):
    """A memmap block is read into host memory by ``stage_block`` itself —
    a copy that shares no page with the file (``np.ascontiguousarray``
    would pass the view on and leave the disk read to the device copy) —
    its bytes counted as the reference counts them; a 'col' file's block
    (a strided view) comes out contiguous and equal."""
    A = _arr(600, 5)
    for layout in ("row", "col"):
        save_both(A, f"sb_{layout}", layout=layout)
        got = []
        for side in (REF, PORT):
            storage, _ = STORAGE[side.name]
            X = side.fm.get_dense_matrix(f"sb_{layout}")
            with counting(side, ("stage_bytes_read",)) as c:
                blk = storage.prefetch.stage_block(X.m, 40, 300,
                                                   to_device=False)
            got.append(c)
            np.testing.assert_array_equal(np.asarray(blk), A[40:300])
        assert got[1] == got[0] == {"stage_bytes_read": 260 * 5 * 4}
        assert type(blk) is np.ndarray and blk.flags.c_contiguous
        assert not np.shares_memory(blk, X.m.store._mm)
        t0 = PORT.metrics.root_counter("stage_read_seconds")
        t = tstorage.prefetch.stage_block(X.m, 0, 64)
        assert PORT.metrics.root_counter("stage_read_seconds") > t0
        assert isinstance(t, torch.Tensor) and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), A[:64])


@pytest.mark.parametrize("dtype,layout", [
    (dt, lay) for dt in DTYPES for lay in ("row", "col")] + [
    (np.int64, "row")])
def test_disk_dtypes_stage_canonical(data_dirs, dtype, layout):
    """A float64 or int64 file is staged in its canonical type (float32,
    int32), as the reference's transfer with x64 off delivers it — never
    copied wide to the device; the bytes read are the file's, and the
    counters, dtypes and values equal the reference's."""
    A = (_arr(900, 4) * 10).astype(dtype)
    save_both(A, "dt", layout=layout)
    X = PORT.fm.get_dense_matrix("dt")
    blk = tstorage.prefetch.stage_block(X.m, 0, 100)
    want = {np.float64: torch.float32, np.int64: torch.int32}.get(
        dtype, torch.from_numpy(A[:1]).dtype)
    assert blk.dtype == want == X.m.dtype

    def program(f):
        Xd = f.get_dense_matrix("dt")
        return [f.colSums(Xd), Xd * 2]

    with both_conf(io_partition_bytes=4096):
        ref, port = both(program, mode="ooc")
        sync = [PORT.fm.as_np(o) for o in PORT.fm.materialize(
            *program(PORT.fm), mode="ooc", prefetch=False)]
    for r, t, s in zip(ref, port, sync):
        np.testing.assert_allclose(t, r, rtol=1e-6)
        np.testing.assert_array_equal(t, s)


def test_bf16_fmat_in_each_package(data_dirs, tmp_path):
    """What each package does with bfloat16.  The reference writes an
    ml_dtypes bf16 array under numpy's name for it, '<V2', which neither
    package reads back as a matrix (both raise on the element type); the
    port writes a bf16 tensor as float32, its host staging type, and the
    reference reads that file.  ROADMAP §C records the difference."""
    import jax.numpy as jnp
    A = _arr(40, 3)
    jstorage.save_matrix(tmp_path / "ref_bf16.fmat",
                         jnp.asarray(A).astype(jnp.bfloat16))
    assert b'"dtype": "<V2"' in (tmp_path / "ref_bf16.fmat").read_bytes()
    assert jstorage.read_header(tmp_path / "ref_bf16.fmat").dtype.kind == "V"
    for side in (REF, PORT):
        storage, _ = STORAGE[side.name]
        st = storage.open_matrix(tmp_path / "ref_bf16.fmat")
        with pytest.raises(TypeError, match="unsupported element type"):
            (TFMMatrix if side is PORT else _jfmmatrix())(
                st.header.shape, st.header.dtype, store=st)
    tstorage.save_matrix(tmp_path / "port_bf16.fmat",
                         torch.from_numpy(A).to(torch.bfloat16))
    h = jstorage.read_header(tmp_path / "port_bf16.fmat")
    assert h.dtype == np.float32
    want = torch.from_numpy(A).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        np.asarray(jstorage.open_matrix(tmp_path / "port_bf16.fmat")
                   .logical()), want)


def _jfmmatrix():
    from repro.core.matrix import FMMatrix
    return FMMatrix


def test_drop_cache_ranges(tmp_path, monkeypatch):
    """``drop_cache`` asks the kernel to drop a row range's pages of a
    'row' file (the whole body of a 'col' file), after the fsync a just
    written file needs: DONTNEED leaves dirty pages in the cache."""
    calls = []
    monkeypatch.setattr(tstorage.store.os, "posix_fadvise",
                        lambda fd, off, n, adv: calls.append((off, n, adv)),
                        raising=False)
    A = _arr(256, 4)
    st = tstorage.create_matrix(tmp_path / "w.fmat", A.shape, A.dtype)
    st.write_rows(0, A)
    st.flush()
    with open(st.path, "rb+") as f:
        import os
        os.fsync(f.fileno())
    st.drop_cache(16, 80)
    st.drop_cache()
    row = 4 * 4
    dont = getattr(tstorage.store.os, "POSIX_FADV_DONTNEED", 4)
    assert calls == [(4096 + 16 * row, 64 * row, dont),
                     (4096, 256 * row, dont)]
    tstorage.save_matrix(tmp_path / "c.fmat", A, layout="col")
    tstorage.open_matrix(tmp_path / "c.fmat").drop_cache(16, 80)
    assert calls[-1] == (4096, 256 * row, dont)
    np.testing.assert_array_equal(
        np.asarray(tstorage.open_matrix(tmp_path / "w.fmat").logical()), A)


def test_close_leaves_live_views_readable(data_dirs):
    """``MmapStore.close()`` drops the store's own mapping (reads through
    it raise) but never unmaps under a live view: a block, a CPU tensor
    staged from it and a whole-mode result viewing the file's pages all
    still read the file, also after it is unlinked."""
    A = _arr(512, 4)
    Xd = PORT.fm.load_dense_matrix(A, "life")
    store = Xd.m.store
    view = store.block(0, 128)
    tensor = torch.from_numpy(np.asarray(store.logical()))  # shares pages
    (Y,) = PORT.fm.materialize(Xd * 1.0, mode="whole")
    store.close()
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.block(0, 1)
    store.path.unlink()
    np.testing.assert_array_equal(view, A[:128])
    np.testing.assert_array_equal(tensor.numpy(), A)
    np.testing.assert_array_equal(PORT.fm.as_np(Y), A)


def test_reference_close_unmaps_under_live_views(tmp_path):
    """The reference-side fact ROADMAP §C records: the reference's
    ``MmapStore.close()`` closes the ``mmap`` under a live numpy view, and
    the view's next read faults (SIGSEGV), in a subprocess."""
    import os
    import pathlib
    import signal
    import subprocess
    import sys
    code = ("import numpy as np\n"
            "from repro.storage import format as f\n"
            f"f.save_matrix({str(tmp_path / 'a.fmat')!r}, "
            "np.ones((64, 4), np.float32))\n"
            f"st = f.open_matrix({str(tmp_path / 'a.fmat')!r})\n"
            "v = st.block(0, 8)\n"
            "st.close()\n"
            "print('closed', flush=True)\n"
            "print(float(v.sum()), flush=True)\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=root)
    assert proc.stdout.splitlines()[:1] == ["closed"], proc.stderr[-2000:]
    assert proc.returncode == -signal.SIGSEGV, (proc.returncode,
                                                proc.stdout)


def test_plan_cache_mesh_key_not_id():
    """Cache keys use a mesh's structure, never ``id(mesh)`` (which the
    collector can reissue to another mesh): two equal one-device meshes
    share one cache entry, in both packages alike."""
    import jax
    from jax.sharding import Mesh as JMesh
    from repro_torch.launch.mesh import Mesh as TMesh
    meshes = {REF.name: lambda: JMesh(np.array(jax.devices()[:1]),
                                      ("data",)),
              PORT.name: lambda: TMesh([torch.device("cpu")], ("data",))}
    A = _arr(64, 3)
    sizes = {}
    for side in (REF, PORT):
        mz, fm = side.mz, side.fm
        mz.clear_plan_cache()
        m1, m2 = meshes[side.name](), meshes[side.name]()
        assert mz._mesh_key(m1) == mz._mesh_key(m2)
        assert mz._mesh_key(m1) != mz._mesh_key(None)
        with counting(side, ("shards", "partition_steps")) as c:
            (a,) = fm.materialize(fm.colSums(fm.conv_R2FM(A) * 2.0),
                                  mesh=m1)
            n_before = len(mz._PLANS)
            (b,) = fm.materialize(fm.colSums(fm.conv_R2FM(A) * 2.0),
                                  mesh=m2)
        assert len(mz._PLANS) == n_before  # equal structure: a cache hit
        np.testing.assert_allclose(fm.as_np(b).ravel(), 2 * A.sum(0),
                                   rtol=1e-5)
        np.testing.assert_array_equal(fm.as_np(a), fm.as_np(b))
        sizes[side.name] = (n_before, dict(c))
    assert sizes[PORT.name] == sizes[REF.name]
