"""The ``fm.serve`` arm of the fuzz twin (tests/test_torch_parity_fuzz.py):
the reference's FUZZ_SERVE arm (``eval_engine_served`` in
tests/test_parity_fuzz.py) run in both packages.

Each of the generator's programs has its outputs split round-robin into
2–3 requests, each submitted from its own thread into one admission window
of an `Engine` — the reference's interpreter, splitting and serving code,
run with each package's ``fm`` in its globals and, for the port, its
``import repro.core.serve`` answered by ``repro_torch.core.serve``.  Both
packages are held to the generator's float64 numpy oracle (normalized
error ≤ 2e-3, the reference's limit) and to each other exactly on the plan
counters of the call (``helpers_twin.COUNTERS``; ``pass_bytes_in`` as a
multiset, since two groups of one round finish in either order) and on the
kernels each request's plan dispatches.  A fixed budget: SERVE_EXAMPLES of
the dense arm's programs in ``whole``, ``stream`` and ``ooc`` (host RAM)
mode, and the reference's anchor, ``test_known_program_served_parity``, in
every mode.

The counters are exact only when each side serves its k requests in ONE
admission window.  The reference's evaluator opens a 2,000 ms window
(``max_window_requests=k`` closes it early); a submit that reached its
Engine after the window closed would make that side run two windows and
two streams.  The twin's copy of the evaluator therefore gets an Engine
whose window is ``WINDOW_MS`` — it still closes at the k-th request, so
it costs nothing when all k arrive — and each side must have served its
requests in one window of k, or the cell fails naming the windows.

A file of its own, so that ``--dist loadfile`` runs it on another worker
than the fuzz twin.
"""
import builtins
import importlib
import types

import numpy as np
import pytest

import test_torch_parity_fuzz as twin
from helpers_twin import (PORT, REF, _port_on_cpu, both_conf,  # noqa: F401
                          counting, time_limit)
from test_torch_parity_fuzz_batch import _request_kernels

pytestmark = pytest.mark.usefixtures("time_limit")

ref = twin.ref
SERVE_EXAMPLES = 24
CHUNKS = 3
#: The twin's admission window: long enough for every submit of a cell
#: under any load; the window still closes at its k-th request.
WINDOW_MS = 30_000
#: Sizes of the windows each side's Engine ran in the current cell.
WINDOWS: list = []


def _long_window(serve_mod):
    """``serve_mod`` as the evaluator imports it, its Engine opening
    ``WINDOW_MS`` windows and recording each window's size."""
    class Engine(serve_mod.Engine):
        def __init__(self, *, window_ms, **kw):
            super().__init__(window_ms=WINDOW_MS, **kw)

        def _run_window(self, window):
            WINDOWS.append(len(window))
            return super()._run_window(window)
    return types.SimpleNamespace(Engine=Engine)


def _importer(package):
    """``import repro.<x>`` answered by ``<package>.<x>``, with the serve
    module's Engine under ``_long_window``: the reference's serving code,
    run against either package."""
    def __import__(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name.startswith("repro."):
            mod = importlib.import_module(
                f"{package}.{name[len('repro.'):]}")
            if name == "repro.core.serve" and fromlist:
                return _long_window(mod)
            return mod if fromlist else importlib.import_module(package)
        return builtins.__import__(name, globals, locals, fromlist, level)
    return __import__


#: The reference's served evaluator with each side's interpreter.
_SERVED = {
    REF.name: types.FunctionType(
        ref.eval_engine_served.__code__,
        {**vars(ref), "_lazy_outputs": twin._ref_lazy_outputs,
         "__builtins__": {**vars(builtins),
                          "__import__": _importer("repro")}}),
    PORT.name: types.FunctionType(
        ref.eval_engine_served.__code__,
        {**vars(ref), "fm": PORT.fm,
         "_lazy_outputs": twin._port_lazy_outputs,
         "__builtins__": {**vars(builtins),
                          "__import__": _importer("repro_torch")}}),
}


@pytest.fixture(autouse=True)
def _fuzz_config():
    with both_conf(io_partition_bytes=2048):  # real multi-partition runs
        yield


def check_served_program(prog, mode: str = "mem") -> str | None:
    """Both packages' served runs against the oracle and each other in one
    of the generator's cells; an error string, or None."""
    refs = ref.eval_numpy(prog)
    counters = []
    k = min(3, len(prog.outputs))
    for side, lazy_outputs, backend in twin._SIDES:
        served = side.metrics.root_counter("serve_requests")
        WINDOWS.clear()
        with counting(side) as c:
            gots = _SERVED[side.name](prog, backend, mode)
        if side.metrics.root_counter("serve_requests") == served:
            return f"{side.name}: its own Engine served no request"
        if WINDOWS != [k]:
            return (f"{side.name}: its {k} requests were served in "
                    f"windows of {WINDOWS}, not in one")
        c["pass_bytes_in"] = sorted(c["pass_bytes_in"])
        counters.append(c)
        for o, got, want in zip(prog.outputs, gots, refs, strict=True):
            if got.shape != want.shape:
                return f"{side.name} r{o}: shape {got.shape} != {want.shape}"
            if not np.isfinite(got).all() and np.isfinite(want).all():
                return f"{side.name} r{o}: non-finite served result"
            scale = max(1.0, float(np.max(np.abs(want))))
            err = float(np.max(np.abs(got - want))) / scale
            if err > 2e-3:
                return (f"{side.name} r{o}: served normalized max abs err "
                        f"{err:.2e}")
    if counters[1] != counters[0]:
        return f"counters: port {counters[1]}, reference {counters[0]}"
    kr, kp = (_request_kernels(side, lazy, prog)
              for side, lazy, _ in twin._SIDES)
    if kp != kr:
        return f"kernels: port {kp}, reference {kr}"
    return None


def _run(progs, modes):
    for prog in progs:
        for mode in modes:
            err = check_served_program(prog, mode)
            REF.mz.clear_plan_cache()
            PORT.mz.clear_plan_cache()
            assert err is None, f"{mode}: {err}\nprogram:\n{prog!r}"


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dag_served_parity(chunk):
    lo = SERVE_EXAMPLES * chunk // CHUNKS
    hi = SERVE_EXAMPLES * (chunk + 1) // CHUNKS
    _run((ref.generate(twin.BASE_SEED + i) for i in range(lo, hi)),
         modes=("mem", "stream", "ooc"))


def test_known_program_served_parity():
    """The reference's always-on anchor: a hand-pinned multi-output
    multipass program served through an Engine admission window, its
    requests submitted from concurrent threads, in every mode."""
    prog = ref.Program(
        seed=6789, n=96, p=3, dtype="f32",
        ops=[
            ("colsums", 0),                # -> r1  pass-1 sink
            ("escalar", 1, "div", 2.0),    # -> r2  pass-1 epilogue
            ("sweeprow", 0, 2, "sub"),     # -> r3  pass-2 row-local sweep
            ("sapply", 3, "abs"),          # -> r4  pass-2 chain
            ("colmaxs", 4),                # -> r5  pass-2 sink
            ("sumall", 0),                 # -> r6  independent sink
        ],
        outputs=[3, 5, 6])
    _run([prog], modes=("mem", "stream", "ooc"))
