"""Twin of tests/test_parity_fuzz.py: random GenOp DAGs run through the
JAX package (``xla``) and the port (``torch``, on the CPU), in ``whole``
mode, each held to the generator's float64 numpy oracle.

The reference's generator, oracle and program interpreter are imported from
tests/test_parity_fuzz.py by path (``tests/`` is not a package); the port
runs the SAME interpreter (``_lazy_outputs``) with the port's ``fm`` in its
globals, so both packages build each program op for op.  Per program the
two must also agree exactly on ``passes``, ``partition_steps`` and
``epilogue_launches`` and on the kernels the kernel backend dispatches
(``pallas`` units against ``cuda`` units).  A fixed budget — EXAMPLES dense
programs from seed BASE_SEED and SPARSE_EXAMPLES over an ELL source on both
sides (the generator's programs with register 0 made sparse, as its
FUZZ_SPARSE arm does) — plus the reference's hand-pinned epilogue,
multipass and sparse programs.  Streams are cut into 2 KiB partitions, as
in the reference.

Left to later slices: the reference's stream and ooc cells (ROADMAP A7),
its ``fm.batch`` arm (A11), its ``fm.serve`` arm (A12) and its meshed arm
(A13), with their anchors ``test_known_program_batched_parity``,
``test_known_program_served_parity`` and
``test_known_program_meshed_parity``.
"""
import dataclasses
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from helpers_twin import (PORT, REF, _port_on_cpu, both_conf,  # noqa: F401
                          counting)
from repro_torch.core.matrix import FMMatrix
from repro_torch.core.sparse import csr_from_dense, ell_from_csr_rows
from repro_torch.storage.sparse import SparseEllStore

_SPEC = importlib.util.spec_from_file_location(
    "_reference_parity_fuzz",
    pathlib.Path(__file__).with_name("test_parity_fuzz.py"))
ref = importlib.util.module_from_spec(_SPEC)
sys.modules[_SPEC.name] = ref  # its dataclasses look their module up
_SPEC.loader.exec_module(ref)

EXAMPLES = 60
SPARSE_EXAMPLES = 30
BASE_SEED = 0
CHUNKS = 6


def _port_sparse_fm(xn: np.ndarray, *, disk: bool):
    """Register 0 of a sparse program on the port: the same ELL slab the
    reference's ``_sparse_fm`` builds, as a device-tier store."""
    assert not disk, "the disk tier comes with ROADMAP A7"
    indptr, indices, data = csr_from_dense(xn)
    kmax = max(1, int(np.diff(indptr).max()) if xn.shape[0] else 1)
    blk = ell_from_csr_rows(indptr, indices, data, 0, xn.shape[0], kmax,
                            xn.shape[1])
    store = SparseEllStore(torch.as_tensor(blk.cols),
                           torch.as_tensor(blk.vals), xn.shape[1])
    return PORT.fm.FM(FMMatrix(xn.shape, store.dtype, store=store))


#: The reference's interpreter with the port's fm and sparse constructor.
_port_lazy_outputs = types.FunctionType(
    ref._lazy_outputs.__code__,
    {**vars(ref), "fm": PORT.fm, "_sparse_fm": _port_sparse_fm})

_SIDES = ((REF, ref._lazy_outputs, "xla"), (PORT, _port_lazy_outputs, "torch"))


@pytest.fixture(autouse=True)
def _fuzz_config():
    with both_conf(io_partition_bytes=2048):  # real multi-partition runs
        yield


def _kernels(side, lazy_outputs, prog):
    outs = lazy_outputs(prog, "mem")
    return sorted(u.kernel for u in side.Plan([o.m for o in outs])
                  .program(side.kernel_backend).kernel_units)


def check_program(prog) -> str | None:
    """Both packages against the oracle and each other; an error string,
    or None."""
    refs = ref.eval_numpy(prog)
    counters = []
    for side, lazy_outputs, backend in _SIDES:
        with counting(side) as c:
            outs = side.fm.materialize(*lazy_outputs(prog, "mem"),
                                       mode="whole", backend=backend)
        counters.append(c)
        for o, got, want in zip(prog.outputs, outs, refs, strict=True):
            got = np.asarray(side.fm.as_np(got), np.float64)
            if got.shape != want.shape:
                return f"{side.name} r{o}: shape {got.shape} != {want.shape}"
            if not np.isfinite(got).all() and np.isfinite(want).all():
                return f"{side.name} r{o}: non-finite engine result"
            scale = max(1.0, float(np.max(np.abs(want))))
            err = float(np.max(np.abs(got - want))) / scale
            if err > 2e-3:
                return (f"{side.name} r{o}: normalized max abs err "
                        f"{err:.2e}")
    if counters[1] != counters[0]:
        return f"counters: port {counters[1]}, reference {counters[0]}"
    kr, kp = (_kernels(side, lazy, prog) for side, lazy, _ in _SIDES)
    if kp != kr:
        return f"kernels: port {kp}, reference {kr}"
    return None


def _run(progs):
    for prog in progs:
        err = check_program(prog)
        REF.mz.clear_plan_cache()
        PORT.mz.clear_plan_cache()
        assert err is None, f"{err}\nprogram:\n{prog!r}"


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dag_parity(chunk):
    lo, hi = EXAMPLES * chunk // CHUNKS, EXAMPLES * (chunk + 1) // CHUNKS
    _run(ref.generate(BASE_SEED + i) for i in range(lo, hi))


@pytest.mark.parametrize("chunk", range(CHUNKS // 2))
def test_random_sparse_dag_parity(chunk):
    """The generator's programs over a sparse (ELL) register 0 whose
    densified values are the oracle's input."""
    k = CHUNKS // 2
    lo = SPARSE_EXAMPLES * chunk // k
    hi = SPARSE_EXAMPLES * (chunk + 1) // k
    _run(dataclasses.replace(ref.generate(BASE_SEED + EXAMPLES + i),
                             sparse=True) for i in range(lo, hi))


def test_sparse_arm_is_sparse_on_both_sides():
    """Register 0 of a sparse program is an ELL store in both packages
    whose densified values are the oracle's input."""
    prog = dataclasses.replace(ref.generate(BASE_SEED), sparse=True)
    xn = ref._input(prog)
    assert 0 < np.count_nonzero(xn) < xn.size
    for side, build in ((REF, ref._sparse_fm), (PORT, _port_sparse_fm)):
        X = build(xn, disk=False)
        assert type(X.m.store).__name__ == "SparseEllStore"
        assert X.m.store.sparse
        np.testing.assert_array_equal(side.fm.as_np(X), xn)


@pytest.mark.parametrize("name", ["epilogue", "multipass", "sparse"])
def test_known_program_parity(name):
    """The reference's hand-pinned programs (its always-on anchors), in
    whole mode."""
    progs = {
        "epilogue": ref.Program(
            seed=1234, n=96, p=3, dtype="f32",
            ops=[("sapply", 0, "sq"), ("colsums", 1), ("colsums", 0),
                 ("escalar", 3, "div", 2.0), ("emap", 2, 4, "sub"),
                 ("esapply", 5, "sqrt_abs"), ("esum", 6)],
            outputs=[6, 7]),
        "multipass": ref.Program(
            seed=4321, n=96, p=3, dtype="f32",
            ops=[("colsums", 0), ("escalar", 1, "div", 2.0),
                 ("sweeprow", 0, 2, "sub"), ("sapply", 3, "abs"),
                 ("colmaxs", 4), ("sweeprow", 0, 1, "pmin")],
            outputs=[3, 5, 6]),
        "sparse": ref.Program(
            seed=1357, n=130, p=3, dtype="f32", sparse=True,
            ops=[("crossprod", 0, None), ("matmul", 0, 42, 2),
                 ("colsums", 0), ("escalar", 3, "div", 2.0),
                 ("sweeprow", 0, 4, "sub"), ("sapply", 2, "abs")],
            outputs=[1, 5, 6]),
    }
    _run([progs[name]])
