"""Hold the PyTorch port against the JAX package, one ``fm`` program at a
time (shared by the ``tests/test_torch_*`` twins of the reference's engine
tests).

A program is a function ``fm -> [lazy outputs]`` that builds its inputs
from numpy arrays it closes over, so the same function runs in both
packages: ``repro`` executes it on ``xla`` (its own tests also run
``pallas`` in interpret mode, whose outputs they hold to ``xla``'s), the
port on ``torch`` or ``cuda`` (whose kernel wrappers take their plain
versions on CPU tensors).  ``both`` materializes it on each side and
checks, exactly, what the two packages must share:

* the plan counters of the call: ``passes``, ``partition_steps``,
  ``epilogue_launches``, ``streams``, ``prefetch_reuse_hits``, the bytes
  a pass streams (``bytes_streamed``; ``pass_bytes_in``, per pass) and the
  bytes read from the host tier (``stage_bytes_read``);
* the kernels the kernel backend dispatches: the ``kernel_units`` of
  ``Plan(outputs).program("pallas")`` in the reference against those of
  ``Plan(outputs).program("cuda")`` in the port;
* each output's shape and dtype (the numpy dtype too, but for bfloat16).

``both_batched`` does the same for the requests of one ``fm.batch`` call.

The values are then held to the reference test's own oracle and
tolerance, on both sides, by the calling test.
"""
from __future__ import annotations

import contextlib
import dataclasses
import signal

import numpy as np
import pytest

import helpers_cache

from repro.core import fm as jfm
from repro.core import materialize as jmz
from repro.core.fusion import Plan as JPlan
from repro.observability import metrics as jmetrics
from repro_torch.core import fm as tfm
from repro_torch.core import materialize as tmz
from repro_torch.core.fusion import Plan as TPlan
from repro_torch.core.matrix import DenseStore as TDenseStore
from repro_torch.core.matrix import FMMatrix as TFMMatrix
from repro_torch.observability import metrics as tmetrics

COUNTERS = ("passes", "partition_steps", "epilogue_launches", "streams",
            "prefetch_reuse_hits", "bytes_streamed", "stage_bytes_read",
            "pass_bytes_in")

#: Counters of the metrics registry that ``exec_stats()`` does not list.
_METRICS = ("bytes_streamed", "stage_bytes_read")


@dataclasses.dataclass(frozen=True)
class Side:
    name: str
    fm: object
    mz: object
    Plan: type
    kernel_backend: str
    metrics: object


REF = Side("repro", jfm, jmz, JPlan, "pallas", jmetrics)
PORT = Side("repro_torch", tfm, tmz, TPlan, "cuda", tmetrics)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port runs on the CPU here (its default device is CUDA); both
    plan caches start empty."""
    jmz.clear_plan_cache()
    tmz.clear_plan_cache()
    with tfm.conf(device="cpu"):
        yield
    jmz.clear_plan_cache()
    tmz.clear_plan_cache()


#: Seconds a test that waits on a prefetcher thread may take (``time_limit``).
TIME_LIMIT_S = 120


@pytest.fixture()
def time_limit():
    """Fail the test with ``TimeoutError`` after ``TIME_LIMIT_S`` seconds:
    a consumer blocked on a staging queue that nothing will fill raises
    instead of hanging its worker process.  SIGALRM interrupts the main
    thread's blocking waits; pytest runs each test on its process's main
    thread."""
    def expire(signum, frame):
        raise TimeoutError(f"the test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture()
def data_dirs(tmp_path, monkeypatch):
    """Each package's named-matrix registry pointed at a fresh directory of
    its own (the previous setting restored afterwards): ``{side name:
    path}``.  One name then means one file in each package."""
    from repro import storage as jstorage
    from repro_torch import storage as tstorage
    dirs = {}
    for side, storage in ((REF, jstorage), (PORT, tstorage)):
        monkeypatch.setitem(storage.registry._CONF, "data_dir", None)
        dirs[side.name] = tmp_path / f"fmdata-{side.name}"
        side.fm.set_conf(data_dir=str(dirs[side.name]))
    return dirs


def save_both(arr, name: str, **kw):
    """Write ``arr`` under ``name`` into each package's registry with that
    package's own ``fm.load_dense_matrix``; a program then reopens it with
    ``fm.get_dense_matrix(name)``, so running the program twice never
    rewrites a mapped file."""
    for side in (REF, PORT):
        side.fm.load_dense_matrix(arr, name, **kw)


@contextlib.contextmanager
def both_conf(**kw):
    """The same ``fm.conf`` override in both packages."""
    with jfm.conf(**kw), tfm.conf(**kw):
        yield


def _stats(side: Side) -> dict:
    st = side.mz.exec_stats()
    st.update({k: int(side.metrics.root_counter(k)) for k in _METRICS})
    return st


@contextlib.contextmanager
def counting(side: Side, names=COUNTERS):
    """Deltas of the engine's counters over a with-block (``pass_bytes_in``,
    a per-pass tuple of the last execution, as it stands at the end)."""
    before = _stats(side)
    got: dict = {}
    try:
        yield got
    finally:
        after = _stats(side)
        got.update({k: after[k] if k == "pass_bytes_in"
                    else after[k] - before[k] for k in names})


def kernels(side: Side, program) -> list:
    """Kernel units the side's kernel backend lowers ``program`` to."""
    outs = program(side.fm)
    plan = side.Plan([o.m for o in outs])
    return sorted(u.kernel for u in plan.program(side.kernel_backend)
                  .kernel_units)


def both(program, *, backend: str = "torch", mode: str = "whole",
         fuse: bool = True, prefetch=None):
    """Materialize ``program`` in both packages — the reference on
    ``xla``, the port on ``backend`` ('torch' or 'cuda') — in ``mode``,
    and check the counters, the kernel dispatch and the outputs' shapes
    and dtypes.  Returns ``(reference outputs, port outputs)`` as numpy
    arrays."""
    got = {}
    for side, be in ((REF, "xla"), (PORT, backend)):
        with counting(side) as c:
            outs = side.fm.materialize(*program(side.fm), mode=mode,
                                       backend=be, fuse=fuse,
                                       prefetch=prefetch)
        got[side.name] = ([side.fm.as_np(o) for o in outs],
                          [str(o.dtype).removeprefix("torch.") for o in outs],
                          c)
    (ref, rdt, rc), (port, pdt, pc) = got[REF.name], got[PORT.name]
    assert pc == rc, f"counters: port {pc}, reference {rc}"
    assert kernels(PORT, program) == kernels(REF, program)
    assert pdt == rdt, f"dtypes: port {pdt}, reference {rdt}"
    for r, t, dt in zip(ref, port, rdt, strict=True):
        # numpy has no bfloat16: the port hands one back as float32 (its
        # host staging type), the reference as float32 or as ml_dtypes'
        # bf16 (also where it declares float32 for an op on bf16 but
        # computes it in bf16: ROADMAP §C)
        bf16 = "bfloat16" in (dt, r.dtype.name)
        assert t.shape == r.shape and (bf16 or t.dtype == r.dtype)
    return ref, port


def _batch_values(side: Side, res) -> list:
    """A batch's results as numpy: per request an array, or a list of them
    for a tuple request."""
    return [[side.fm.as_np(o) for o in r] if isinstance(r, list)
            else side.fm.as_np(r) for r in res]


def both_batched(program, *, backend: str = "torch", **kw):
    """``both`` for a batch: ``program(fm)`` returns the requests of one
    ``fm.batch`` call (each a lazy matrix or a tuple of them), run in both
    packages — the reference on ``xla``, the port on ``backend`` — with
    ``kw`` (``mode``, ``prefetch``, ...).  Checks the counters of the call,
    the kernels each request's plan dispatches and the outputs' shapes and
    dtypes, as ``both`` does.  Returns ``(reference results, port
    results)``, each per request a numpy array, or a list of them for a
    tuple request."""
    got = {}
    for side, be in ((REF, "xla"), (PORT, backend)):
        with counting(side) as c:
            res = side.fm.batch(*program(side.fm), backend=be, **kw)
        flat = [o for r in res for o in (r if isinstance(r, list) else [r])]
        got[side.name] = (_batch_values(side, res),
                          [str(o.dtype).removeprefix("torch.") for o in flat],
                          [side.fm.as_np(o).shape for o in flat], c)
    (ref, rdt, rsh, rc), (port, pdt, psh, pc) = got[REF.name], got[PORT.name]
    assert pc == rc, f"counters: port {pc}, reference {rc}"
    assert pdt == rdt, f"dtypes: port {pdt}, reference {rdt}"
    assert psh == rsh, f"shapes: port {psh}, reference {rsh}"

    def request_kernels(side):
        out = []
        for req in program(side.fm):
            outs = req if isinstance(req, tuple) else (req,)
            plan = side.Plan([o.m for o in outs if o.m.is_virtual])
            out.append(sorted(u.kernel for u in plan.program(
                side.kernel_backend).kernel_units))
        return out

    assert request_kernels(PORT) == request_kernels(REF)
    return ref, port


# ---------------------------------------------------------------------------
# Staging fault injection: the port's twin of helpers_cache.FlakyStore
# ---------------------------------------------------------------------------

class FlakyStore(TDenseStore):
    """A host-tier store of the port whose ``block()`` raises
    ``helpers_cache.StagingFault`` after ``fail_after`` partition reads,
    as the reference's ``helpers_cache.FlakyStore`` does; ``heal()`` turns
    the fault off."""

    def __init__(self, data: np.ndarray, fail_after: int):
        super().__init__(np.asarray(data))
        self.fail_after = int(fail_after)
        self.reads = 0
        self.failed = False

    def block(self, start: int, stop: int):
        if self.fail_after >= 0 and self.reads >= self.fail_after:
            self.failed = True
            raise helpers_cache.StagingFault(
                f"injected staging failure after {self.reads} reads")
        self.reads += 1
        return super().block(start, stop)

    def heal(self):
        self.fail_after = -1


def flaky_matrix(side: Side, arr: np.ndarray, fail_after: int):
    """``(matrix, store)``: a host-tier matrix of ``side`` whose partition
    staging fails after ``fail_after`` block reads."""
    if side is REF:
        return helpers_cache.flaky_matrix(arr, fail_after)
    arr = np.asarray(arr)
    store = FlakyStore(arr, fail_after)
    return TFMMatrix(arr.shape, arr.dtype, store=store, name="flaky"), store
