"""Partition staging and the background partition prefetcher (PyTorch port
of repro.storage.prefetch; paper §III-F, I/O overlap).

``stage_block`` is the one definition of how an I/O-level partition of a
source reaches the fused step.  Two callers share it: the executor's
synchronous path (``_inline_partitions``, the prefetch-off ablation) and
``PartitionPrefetcher``, a worker thread that stages partition i+1.. while
the compute thread runs partition i's step, so the host read, the
host→device copy and the step overlap.  That overlap is the mechanism
behind the paper's claim that out-of-core execution tracks in-memory.

On a CUDA engine device the prefetcher stages through a small ring of
pinned host slots and a side CUDA stream:

* the worker copies a partition's rows from the numpy store — a host-RAM
  array, or the memory map of an ``.fmat`` file, whose pages are read from
  disk by that copy — into a pinned slot (the slow-tier read, counted in
  ``stage_bytes_read`` / ``stage_read_seconds``), issues the host→device
  copy on the side stream with ``non_blocking=True``, records an event and
  enqueues the partition;
* the consumer makes the compute stream wait on that event and records
  the staged tensors onto the compute stream before yielding them.

The six rules this rests on (pinned reuse, ordering without a host stall,
device lifetimes across streams, the worker's device, shutdown, bounded
memory) are each stated where they are enforced, tagged "Invariant n".
On a CPU engine device the same thread and queue stage plain CPU tensors.
No path gives way to another: a failure to pin, to make the stream or to
copy raises ``PrefetchError`` naming the partition and the source.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import warnings
import weakref
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtypes
from ..core.sparse import SparseBlock
from ..observability import metrics
from ..observability.trace import TRACER

_DONE = object()

#: Hard ceiling on a negotiated prefetch depth: beyond this the queue only
#: adds staged-memory pressure (depth × partition bytes) without hiding any
#: more latency.
MAX_NEGOTIATED_DEPTH = 8

#: Pinned host slots of a CUDA prefetcher's ring: the worker fills one while
#: the copy out of the other runs.
PINNED_SLOTS = 2


def negotiate_depth(n_members: int, partition_nbytes: int,
                    base: Optional[int] = None,
                    budget_bytes: Optional[int] = None) -> int:
    """Group-aware prefetch depth for a co-scheduled stream: ``base``
    (default the configured ``prefetch_depth``) plus one slot per extra
    member, capped at `MAX_NEGOTIATED_DEPTH` and, when ``budget_bytes`` is
    given, at the partitions that fit it; never below 1."""
    from . import registry
    if base is None:
        base = int(registry.get_conf("prefetch_depth"))
    depth = min(base + max(0, int(n_members) - 1), MAX_NEGOTIATED_DEPTH)
    if budget_bytes and partition_nbytes > 0:
        depth = min(depth, int(budget_bytes) // int(partition_nbytes))
    return max(1, depth)


def _leaves(blk):
    """A block's arrays: a dense block itself, a ``SparseBlock``'s cols and
    vals."""
    return (blk.cols, blk.vals) if isinstance(blk, SparseBlock) else (blk,)


def _host_read(a: np.ndarray) -> np.ndarray:
    """A block's leaf read into contiguous host memory in its canonical
    type (float64 → float32, int64 → int32, as the reference's transfer
    with x64 off).  A memory-mapped view — a disk block — is always copied
    here: ``np.ascontiguousarray`` would hand the view itself on, and the
    disk read would then happen inside the device copy, outside the
    timed read."""
    dt = dtypes.np_equiv(dtypes.canon(a.dtype))
    if isinstance(a, np.memmap):
        return np.array(a, dtype=dt, order="C")
    return np.ascontiguousarray(a, dtype=dt)


def stage_block(mat, start: int, stop: int, *, to_device: bool = True,
                device=None, pinned=None):
    """Read rows [start, stop) of ``mat`` and stage them for the fused step:

    * a host- or disk-tier block — dense numpy (a memmap view for an
      ``.fmat`` file), or a host ELL slab's or CSR file's ``SparseBlock``
      of numpy ``cols`` / ``vals``, leaf by leaf — is read into contiguous
      host memory in its canonical type: the slow-tier read, its source
      bytes counted in ``stage_bytes_read`` and its time in
      ``stage_read_seconds``.  ``pinned`` (a prefetcher's `_PinnedSlot`)
      makes that copy land in its pinned buffer and the device copy run
      asynchronously on the current stream; without it the host copy is
      copied from pageable memory, which blocks the host until it lands.
      ``to_device=False`` returns the host block;
    * a device-tier block (dense, or a device slab's ``SparseBlock``) is
      passed through as the store's own view, with no tier read.  The
      reference copies a device block when its consumer will donate it;
      PyTorch has no donation, and no step writes into its inputs.

    ``device`` is where the block goes (None: the engine's device).
    Records a ``stage`` span.  An error (a failed read of the store)
    propagates unchanged to the caller."""
    t0 = time.perf_counter()
    blk = mat.block(start, stop)
    sparse = isinstance(blk, SparseBlock)
    leaves = _leaves(blk)
    if isinstance(leaves[0], np.ndarray):
        nbytes = sum(int(a.nbytes) for a in leaves)
        leaves = [_host_read(a) if pinned is None
                  else pinned.fill((id(mat), i), a)
                  for i, a in enumerate(leaves)]
        metrics.inc("stage_bytes_read", nbytes)
        metrics.inc("stage_read_seconds", time.perf_counter() - t0)
        if to_device:
            if device is None:
                from . import registry  # deferred: registry imports core
                device = registry.device()
            leaves = [torch.from_numpy(a).to(device) if pinned is None
                      else pinned.copy(a, device) for a in leaves]
        blk = SparseBlock(*leaves, blk.ncol) if sparse else leaves[0]
    TRACER.record("stage", t0, time.perf_counter(),
                  {"start": int(start), "stop": int(stop)})
    return blk


def _source_name(mat) -> str:
    """Best human-readable identity of a staged source, for error context:
    the matrix's registry name, its backing file path, or its type."""
    name = getattr(mat, "name", "")
    if name:
        return str(name)
    store = getattr(mat, "store", None)
    path = getattr(store, "path", None) or getattr(mat, "path", None)
    if path:
        return str(path)
    return type(store or mat).__name__


class PrefetchError(RuntimeError):
    """A staging-thread failure, re-raised on the consumer side."""


#: Every constructed prefetcher, weakly held — the leak audit: after a
#: stream ends (normally or by a fault) no entry may have a live worker
#: thread or staged partitions still queued.
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def live_prefetchers() -> list:
    """Prefetchers whose worker thread is still running — must be empty
    between streams; a non-empty result is a shutdown leak."""
    return [p for p in list(_LIVE) if p.alive]


def staged_leaks() -> list:
    """Closed-or-dead prefetchers still holding staged partitions in their
    queue (device memory held past shutdown) — must be empty."""
    return [p for p in list(_LIVE) if not p.alive and p.queued]


class _PinnedSlot:
    """One slot of a CUDA prefetcher's pinned ring: a pinned host buffer
    per (source, leaf), sized at first use, the timing events of the
    host→device copies out of it, and ``done``, the side-stream event
    recorded after the last of those copies."""

    def __init__(self):
        self.bufs: dict = {}
        self.copies: list = []
        self.done: Optional[torch.cuda.Event] = None

    def fill(self, key, arr: np.ndarray) -> torch.Tensor:
        """Copy ``arr`` into this slot's pinned buffer for ``key``, in its
        canonical type: the slow tier's read (for a memmap view, the disk
        read itself), by torch's CPU copy on its intra-op threads — the
        fastest fill ``examples/torch_prefetch_fill.py`` found, alone and
        end to end, though it slows the compute thread's own host work
        while it runs (PERF.md).  A strided view (a 'col' file's block) is
        gathered by the same copy."""
        with warnings.catch_warnings():
            # a read-only numpy store is read here, never written
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(arr)
        dt = dtypes.canon(src.dtype)
        buf = self.bufs.get(key)
        if buf is None or buf.dtype != dt or buf.numel() < src.numel():
            buf = self.bufs[key] = torch.empty(src.numel(), dtype=dt,
                                               pin_memory=True)
        return buf[:src.numel()].view(src.shape).copy_(src)

    def copy(self, host: torch.Tensor, device) -> torch.Tensor:
        """The asynchronous host→device copy of a filled buffer on the
        current (side) stream, bracketed by timing events."""
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        out = host.to(device, non_blocking=True)
        end.record()
        self.copies.append((begin, end))
        return out

    def settle(self) -> float:
        """Block until every copy out of this slot has completed; the
        device seconds they took."""
        if self.done is not None:
            self.done.synchronize()
            self.done = None
        secs = sum(b.elapsed_time(e) for b, e in self.copies) / 1e3
        self.copies.clear()
        return secs


class PartitionPrefetcher:
    """Iterate ``(start, stop, {key: staged_block})`` over the partitions of
    rows [row_start, long_dim).

    sources: ``[(key, matrix)]``, each matrix exposing ``block(start,
    stop)`` (an FMMatrix or a bare store).  ``depth`` bounds the staged
    partitions waiting in the queue; ``reuse`` maps keys to the previous
    pass's resident final-partition blocks, served instead of re-staged
    (``prefetch_reuse_hits``); ``device`` is where blocks are staged (None:
    the engine's device), ``row_start`` where the range begins (one
    prefetcher per shard, ROADMAP A13).  ``donate`` is the reference's
    knob: PyTorch has no buffer donation, and it has no effect."""

    def __init__(self, sources: Sequence[Tuple[int, object]],
                 partition_rows: int, long_dim: int, *, depth: int = 2,
                 donate: bool = True, stage_to_device: bool = True,
                 reuse: Optional[dict] = None, row_start: int = 0,
                 device=None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.sources = list(sources)
        self.partition_rows = int(partition_rows)
        self.long_dim = int(long_dim)
        self.row_start = int(row_start)
        self.depth = int(depth)
        self.donate = donate
        self.stage_to_device = stage_to_device
        if stage_to_device and device is None:
            from . import registry  # deferred: registry imports core
            device = registry.device()
        self.device = None if device is None else torch.device(device)
        self.reuse = dict(reuse) if reuse else None
        self._cuda = bool(stage_to_device and self.device.type == "cuda")
        # The stream the consumer's steps run on: the constructing thread's
        # current stream (the constructing thread is the consumer).
        self._compute = (torch.cuda.current_stream(self.device)
                         if self._cuda else None)
        self._side: Optional[torch.cuda.Stream] = None  # made by the worker
        self._slots = ([_PinnedSlot() for _ in range(PINNED_SLOTS)]
                       if self._cuda else [])
        # partition index -> compute-stream event recorded once the
        # consumer has finished with that partition (Invariant 6)
        self._consumed: dict[int, torch.cuda.Event] = {}
        self._cond = threading.Condition()
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._closed = False
        # Metrics scopes open on the CONSTRUCTING thread: the worker adopts
        # them so background staging is attributed to the fm.collect_stats()
        # request that spawned this pipeline (Invariant 4).
        self._scopes = metrics.current_scopes()
        self._thread = threading.Thread(
            target=self._worker, name="fm-prefetch", daemon=True)
        _LIVE.add(self)
        self._thread.start()

    # -- staging thread --------------------------------------------------------
    def _worker(self):
        with metrics.use_scopes(self._scopes):
            try:
                # Invariant 4: the worker stages on the engine's device,
                # set explicitly — a new thread's current device is 0.
                with (torch.cuda.device(self.device) if self._cuda
                      else contextlib.nullcontext()):
                    if self._loop():
                        self._put(_DONE)
            except Exception as exc:  # noqa: BLE001 - forwarded to consumer
                self._put(exc)

    def _loop(self) -> bool:
        """Stage every partition in order; False once close() stops it."""
        start, idx = self.row_start, 0
        while start < self.long_dim:
            if not self._wait_consumed(idx - self.depth - 2):
                return False
            stop = min(start + self.partition_rows, self.long_dim)
            final = stop >= self.long_dim
            slot = self._slots[idx % PINNED_SLOTS] if self._cuda else None
            blocks = {}
            for key, mat in self.sources:
                if final and self.reuse and key in self.reuse:
                    # the identical final partition, still on the device
                    # from the previous pass
                    blocks[key] = self.reuse[key]
                    metrics.inc("prefetch_reuse_hits")
                    continue
                try:
                    blocks[key] = self._stage(mat, start, stop, slot)
                except Exception as exc:
                    raise PrefetchError(
                        f"prefetch thread failed staging rows "
                        f"[{start}, {stop}) of source "
                        f"{_source_name(mat)!r}: {exc!r}") from exc
            ready = None
            if slot is not None and self._side is not None:
                ready = torch.cuda.Event()
                ready.record(self._side)
                slot.done = ready
            metrics.observe("prefetch_queue_depth", self._q.qsize())
            if not self._put((start, stop, blocks, ready)):
                return False
            start, idx = stop, idx + 1
        return True

    def _stage(self, mat, start: int, stop: int, slot):
        if slot is None:
            return stage_block(mat, start, stop,
                               to_device=self.stage_to_device,
                               device=self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        if slot.done is not None:
            # Invariant 1: a pinned slot is refilled only after the event
            # of its last host→device copy has completed.
            metrics.inc("stage_copy_seconds", slot.settle())
        with torch.cuda.stream(self._side):
            return stage_block(mat, start, stop, device=self.device,
                               pinned=slot)

    def _wait_consumed(self, k: int) -> bool:
        """Invariant 6: partition k + depth + 2 is staged only once the
        compute stream has finished partition k.  The consumer holds
        partition k + 1, the queue at most k + 2 .. k + depth + 1, so with
        the blocks the caching allocator holds back for the compute stream
        (Invariant 3) the staged device memory stays within (depth + 2)
        partitions, however far the device lags the host — provided the
        consumer drops a partition before asking for the next.  False once
        close() stops the wait."""
        if k < 0 or not self._cuda:
            return not self._stop.is_set()
        with self._cond:
            while k not in self._consumed:
                if self._stop.is_set():
                    return False
                self._cond.wait(0.05)
            done = self._consumed.pop(k)
        done.synchronize()
        return not self._stop.is_set()

    def _put(self, item) -> bool:
        """Bounded put that aborts promptly when close() is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side ---------------------------------------------------------
    def __iter__(self) -> Iterator[tuple]:
        idx = 0
        while True:
            if self._cuda and idx:
                done = torch.cuda.Event()
                done.record(self._compute)
                with self._cond:
                    self._consumed[idx - 1] = done
                    self._cond.notify_all()
            t0 = time.perf_counter()
            item = self._q.get()
            t1 = time.perf_counter()
            # Time the compute thread spent blocked on the staging queue:
            # the numerator of prefetch_wait_frac (pipeline fill included).
            metrics.inc("prefetch_wait_seconds", t1 - t0)
            TRACER.record("prefetch_wait", t0, t1)
            if item is _DONE:
                self._closed = True
                return
            if isinstance(item, PrefetchError):
                # Already carries partition + source context from _worker.
                self._closed = True
                raise item
            if isinstance(item, Exception):
                self._closed = True
                raise PrefetchError(f"prefetch thread failed: {item!r}") \
                    from item
            start, stop, blocks, ready = item
            del item
            if ready is not None:
                self._hand_over(blocks, ready)
            yield start, stop, blocks
            # hold no staged block while waiting for the next (Invariant 6)
            del blocks
            idx += 1

    def _hand_over(self, blocks: dict, ready):
        """Give a staged partition to the compute stream (its own frame, so
        no loop variable outlives the call and holds a block)."""
        # Invariant 2: the compute stream waits on the partition's copies;
        # the host does not (no synchronize), so the next copy overlaps
        # this step.
        self._compute.wait_event(ready)
        # Invariant 3: blocks allocated on the side stream are recorded onto
        # the compute stream, so the caching allocator reuses their memory
        # only after the steps that read them — also when they live on as a
        # resident final partition or are served again as ``reuse``.
        for blk in blocks.values():
            for t in _leaves(blk):
                if t.is_cuda:
                    t.record_stream(self._compute)

    def close(self):
        """Stop the staging thread and drop queued partitions.  Idempotent;
        safe to call mid-stream (early consumer exit) or after exhaustion.

        Invariant 5: drain and join INTERLEAVE — a worker parked in
        ``_put`` on a full queue re-checks ``_stop`` only on its 50 ms
        timeout, so a single drain before the join races it and could leave
        a staged partition in the dead pipeline's queue.  Then the side
        stream is synchronized before the pinned slots are dropped."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        deadline = time.monotonic() + 10.0
        while True:
            self._drain()
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive() or time.monotonic() > deadline:
                break
        self._drain()
        if self._side is not None and not self._thread.is_alive():
            # Invariant 5: no copy may still read a pinned slot when the
            # ring is dropped
            self._side.synchronize()
            metrics.inc("stage_copy_seconds",
                        sum(s.settle() for s in self._slots))
            self._slots = []
        self._closed = True

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def queued(self) -> int:
        """Staged partitions currently parked in the queue (leak audit)."""
        return self._q.qsize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
