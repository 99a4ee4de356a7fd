"""The ``fm.batch`` arm of the fuzz twin (tests/test_torch_parity_fuzz.py):
the reference's FUZZ_BATCH arm (``eval_engine_batched`` in
tests/test_parity_fuzz.py) run in both packages.

Each of the generator's programs has its outputs split round-robin into
2–3 independent requests over the shared sources and executed through one
``fm.batch`` call — the reference's interpreter and splitting code, run
with each package's ``fm`` in its globals.  Both packages are held to the
generator's float64 numpy oracle (normalized error ≤ 2e-3, the reference's
limit) and to each other exactly on the plan counters of the call
(``helpers_twin.COUNTERS``) and on the kernels each request's plan
dispatches (``pallas`` units against ``cuda`` units).  A fixed budget:
BATCH_EXAMPLES of the dense arm's programs in ``whole``, ``stream`` and
``ooc`` (host RAM) mode, in half the dense arm's chunks; and the reference's
anchor, ``test_known_program_batched_parity``, in every mode.

A file of its own, so that ``--dist loadfile`` runs it on another worker
than the fuzz twin.
"""
import types

import numpy as np
import pytest

import test_torch_parity_fuzz as twin
from helpers_twin import (PORT, REF, _port_on_cpu, both_conf,  # noqa: F401
                          counting, time_limit)

pytestmark = pytest.mark.usefixtures("time_limit")

ref = twin.ref
BATCH_EXAMPLES = 30
CHUNKS = twin.CHUNKS // 2

#: The reference's batched evaluator with each side's interpreter.
_BATCHED = {
    REF.name: types.FunctionType(
        ref.eval_engine_batched.__code__,
        {**vars(ref), "_lazy_outputs": twin._ref_lazy_outputs}),
    PORT.name: types.FunctionType(
        ref.eval_engine_batched.__code__,
        {**vars(ref), "fm": PORT.fm,
         "_lazy_outputs": twin._port_lazy_outputs}),
}


@pytest.fixture(autouse=True)
def _fuzz_config():
    with both_conf(io_partition_bytes=2048):  # real multi-partition runs
        yield


def _request_kernels(side, lazy_outputs, prog):
    """The kernels of each request's plan, the requests split as
    ``eval_engine_batched`` splits them."""
    lazies = lazy_outputs(prog, "mem")
    k = min(3, len(lazies))
    out = []
    for i in range(k):
        plan = side.Plan([lazies[j].m for j in range(i, len(lazies), k)])
        out.append(sorted(u.kernel for u in plan.program(
            side.kernel_backend).kernel_units))
    return out


def check_batched_program(prog, mode: str = "mem") -> str | None:
    """Both packages' batched runs against the oracle and each other in one
    of the generator's cells; an error string, or None."""
    refs = ref.eval_numpy(prog)
    counters = []
    for side, lazy_outputs, backend in twin._SIDES:
        with counting(side) as c:
            gots = _BATCHED[side.name](prog, backend, mode)
        counters.append(c)
        for o, got, want in zip(prog.outputs, gots, refs, strict=True):
            if got.shape != want.shape:
                return f"{side.name} r{o}: shape {got.shape} != {want.shape}"
            if not np.isfinite(got).all() and np.isfinite(want).all():
                return f"{side.name} r{o}: non-finite batched result"
            scale = max(1.0, float(np.max(np.abs(want))))
            err = float(np.max(np.abs(got - want))) / scale
            if err > 2e-3:
                return (f"{side.name} r{o}: batched normalized max abs err "
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
            err = check_batched_program(prog, mode)
            REF.mz.clear_plan_cache()
            PORT.mz.clear_plan_cache()
            assert err is None, f"{mode}: {err}\nprogram:\n{prog!r}"


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dag_batched_parity(chunk):
    lo = BATCH_EXAMPLES * chunk // CHUNKS
    hi = BATCH_EXAMPLES * (chunk + 1) // CHUNKS
    _run((ref.generate(twin.BASE_SEED + i) for i in range(lo, hi)),
         modes=("mem", "stream", "ooc"))


def test_known_program_batched_parity():
    """The reference's always-on anchor: a hand-pinned multi-output
    multipass program through ``fm.batch`` in every mode."""
    prog = ref.Program(
        seed=9876, n=96, p=3, dtype="f32",
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
