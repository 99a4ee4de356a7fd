"""Twin of tests/test_parity_fuzz.py: random GenOp DAGs run through the
JAX package (``xla``) and the port (``torch``, on the CPU), each held to
the generator's float64 numpy oracle.

The reference's generator, oracle and program interpreter are imported from
tests/test_parity_fuzz.py by path (``tests/`` is not a package); the port
runs the SAME interpreter (``_lazy_outputs``) with the port's ``fm`` in its
globals, so both packages build each program op for op.  Per program the
two must also agree exactly on the plan counters (``helpers_twin.COUNTERS``)
and on the kernels the kernel backend dispatches (``pallas`` units against
``cuda`` units).  A fixed budget:

* EXAMPLES dense programs from seed BASE_SEED in ``whole`` mode, and the
  first STREAM_EXAMPLES of them in ``stream`` mode and in ``ooc`` mode from
  host RAM;
* SPARSE_EXAMPLES over an ELL source on both sides (the generator's
  programs with register 0 made sparse, as its FUZZ_SPARSE arm does), in
  ``whole`` and ``stream`` mode (a device-tier slab) and in ``ooc`` mode
  from a CSR ``.fmat`` each package writes into its own registry, as the
  reference's generator does;
* the bf16 arm: the generator's f32 programs over BF16_SEEDS with register
  0 cast to bf16 on both sides, held to each other (normalized, within
  bf16's tolerance) with counters, kernels and declared dtypes exact;
* the reference's hand-pinned epilogue, multipass and sparse programs in
  every mode the port has;
* the meshed arm (the reference's FUZZ_MESH ``eval_engine_meshed``, with
  each side's ``fm`` and mesh): the reference over its in-process host
  mesh, the port over a one-device mesh — counters (``shards`` and
  ``shard_merges`` among them) equal to the reference's — and over
  ``Mesh([cpu] × 4)``, held to the oracle.  MESH_EXAMPLES programs always,
  STREAM_EXAMPLES under ``FUZZ_MESH``, and the reference's anchor
  ``test_known_program_meshed_parity`` in every mode.

Streams are cut into 2 KiB partitions, as in the reference, so ``stream``
and ``ooc`` run many partitions; both packages stage them as the
reference's test does (the ``ooc`` cells through the background
prefetcher, the conf default for a host or disk source).  The reference's
``fm.batch`` arm and its anchor ``test_known_program_batched_parity`` are
tests/test_torch_parity_fuzz_batch.py, its ``fm.serve`` arm and
``test_known_program_served_parity`` tests/test_torch_parity_fuzz_serve.py.
"""
import dataclasses
import importlib.util
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_twin import (COUNTERS, PORT, REF, _port_on_cpu,  # noqa: F401
                          both_conf, counting, data_dirs)
from helpers_twin import time_limit  # noqa: F401
from repro_torch.core.matrix import FMMatrix
from repro_torch.core.sparse import csr_from_dense, ell_from_csr_rows
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.storage.sparse import SparseEllStore

pytestmark = pytest.mark.usefixtures("time_limit")

_SPEC = importlib.util.spec_from_file_location(
    "_reference_parity_fuzz",
    pathlib.Path(__file__).with_name("test_parity_fuzz.py"))
ref = importlib.util.module_from_spec(_SPEC)
sys.modules[_SPEC.name] = ref  # its dataclasses look their module up
_SPEC.loader.exec_module(ref)

EXAMPLES = 60
STREAM_EXAMPLES = 30
SPARSE_EXAMPLES = 30
BASE_SEED = 0
CHUNKS = 6
#: The bf16 arm's seeds: a fixed range plus the four programs that raised
#: before fault C6 was closed (ROADMAP §C).
BF16_SEEDS = sorted(set(range(3000, 3030)) | {3036, 3107, 3399, 3402})
#: bf16's tolerance, on errors normalized by the output's scale.
BF16_TOL = 2e-2
#: Programs of the meshed arm without FUZZ_MESH (all STREAM_EXAMPLES with).
MESH_EXAMPLES = 6


def _port_sparse_fm(xn: np.ndarray, *, disk: bool):
    """Register 0 of a sparse program on the port: the same ELL slab the
    reference's ``_sparse_fm`` builds, as a device-tier store — or, for
    the ooc cell, written as a CSR ``.fmat`` and reopened through the
    registry, as the reference does."""
    from repro_torch import storage
    indptr, indices, data = csr_from_dense(xn)
    kmax = max(1, int(np.diff(indptr).max()) if xn.shape[0] else 1)
    blk = ell_from_csr_rows(indptr, indices, data, 0, xn.shape[0], kmax,
                            xn.shape[1])
    if disk:
        m = FMMatrix(xn.shape, xn.dtype, store=SparseEllStore(
            blk.cols, blk.vals, xn.shape[1]))
        return PORT.fm.FM(storage.save_sparse_matrix(m, "fuzz_sparse"))
    store = SparseEllStore(torch.as_tensor(blk.cols),
                           torch.as_tensor(blk.vals), xn.shape[1])
    return PORT.fm.FM(FMMatrix(xn.shape, store.dtype, store=store))


def _ref_sparse_fm(xn: np.ndarray, *, disk: bool):
    """Register 0 of a sparse program on the reference: its own
    ``_sparse_fm`` slab moved to the device tier, the tier the port's slab
    is on, so the two stage alike and ``stage_bytes_read`` compares; for
    the ooc cell its own CSR ``.fmat``."""
    if disk:
        return ref._sparse_fm(xn, disk=True)
    X = ref._sparse_fm(xn, disk=False)
    st = X.m.store
    store = type(st)(jnp.asarray(st.cols), jnp.asarray(st.vals), xn.shape[1])
    return REF.fm.FM(type(X.m)(xn.shape, X.m.dtype, store=store))


#: The reference's interpreter with each side's fm and sparse constructor.
_ref_lazy_outputs = types.FunctionType(
    ref._lazy_outputs.__code__, {**vars(ref), "_sparse_fm": _ref_sparse_fm})
_port_lazy_outputs = types.FunctionType(
    ref._lazy_outputs.__code__,
    {**vars(ref), "fm": PORT.fm, "_sparse_fm": _port_sparse_fm})

_SIDES = ((REF, _ref_lazy_outputs, "xla"), (PORT, _port_lazy_outputs, "torch"))

_EXEC_MODE = {"mem": "whole", "stream": "stream", "ooc": "ooc"}


class _Bf16Source:
    """A side's ``fm`` whose ``conv_R2FM`` builds register 0 in bf16."""

    def __init__(self, fm, cast):
        self._fm, self._cast = fm, cast

    def __getattr__(self, name):
        return getattr(self._fm, name)

    def conv_R2FM(self, arr, host=False):
        return self._fm.conv_R2FM(self._cast(arr), host=host)


_BF16_SIDES = (
    (REF, types.FunctionType(_ref_lazy_outputs.__code__, {
        **_ref_lazy_outputs.__globals__,
        "fm": _Bf16Source(REF.fm, lambda a: jnp.asarray(a, jnp.bfloat16))}),
     "xla"),
    (PORT, types.FunctionType(_port_lazy_outputs.__code__, {
        **_port_lazy_outputs.__globals__,
        "fm": _Bf16Source(PORT.fm,
                          lambda a: torch.as_tensor(a).to(torch.bfloat16))}),
     "torch"))


@pytest.fixture(autouse=True)
def _fuzz_config():
    with both_conf(io_partition_bytes=2048):  # real multi-partition runs
        yield


def _kernels(side, lazy_outputs, prog):
    outs = lazy_outputs(prog, "mem")
    return sorted(u.kernel for u in side.Plan([o.m for o in outs])
                  .program(side.kernel_backend).kernel_units)


def check_program(prog, mode: str = "mem") -> str | None:
    """Both packages against the oracle and each other in one of the
    generator's cells (``mem``, ``stream`` or ``ooc``); an error string,
    or None."""
    refs = ref.eval_numpy(prog)
    counters = []
    for side, lazy_outputs, backend in _SIDES:
        with counting(side) as c:
            outs = side.fm.materialize(*lazy_outputs(prog, mode),
                                       mode=_EXEC_MODE[mode],
                                       backend=backend)
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


def check_bf16_program(prog, mode: str = "mem") -> str | None:
    """The program with register 0 cast to bf16 on both sides, the port
    held to the reference: values normalized by the output's scale within
    BF16_TOL, counters, kernels and declared dtypes exact."""
    got = []
    for side, lazy_outputs, backend in _BF16_SIDES:
        with counting(side) as c:
            outs = side.fm.materialize(*lazy_outputs(prog, mode),
                                       mode=_EXEC_MODE[mode],
                                       backend=backend)
        got.append(([np.asarray(side.fm.as_np(o), np.float64)
                     for o in outs],
                    [str(o.dtype).removeprefix("torch.") for o in outs], c))
    (rv, rdt, rc), (tv, tdt, tc) = got
    for o, r, t in zip(prog.outputs, rv, tv, strict=True):
        if t.shape != r.shape:
            return f"r{o}: shape {t.shape} != {r.shape}"
        scale = max(1.0, float(np.max(np.abs(r))))
        err = float(np.max(np.abs(t - r))) / scale
        if not err <= BF16_TOL:
            return f"r{o}: normalized max abs err {err:.2e}"
    if tc != rc:
        return f"counters: port {tc}, reference {rc}"
    if tdt != rdt:
        return f"dtypes: port {tdt}, reference {rdt}"
    kr, kp = (_kernels(side, lazy, prog) for side, lazy, _ in _BF16_SIDES)
    if kp != kr:
        return f"kernels: port {kp}, reference {kr}"
    return None


def _run(progs, modes=("mem",), check=check_program):
    for prog in progs:
        for mode in modes:
            err = check(prog, mode)
            REF.mz.clear_plan_cache()
            PORT.mz.clear_plan_cache()
            assert err is None, f"{mode}: {err}\nprogram:\n{prog!r}"


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_dag_parity(chunk):
    lo, hi = EXAMPLES * chunk // CHUNKS, EXAMPLES * (chunk + 1) // CHUNKS
    _run(ref.generate(BASE_SEED + i) for i in range(lo, hi))


@pytest.mark.parametrize("chunk", range(CHUNKS // 2))
def test_random_dag_parity_streaming(chunk):
    """The dense programs' stream and ooc (host RAM) cells."""
    k = CHUNKS // 2
    lo = STREAM_EXAMPLES * chunk // k
    hi = STREAM_EXAMPLES * (chunk + 1) // k
    _run((ref.generate(BASE_SEED + i) for i in range(lo, hi)),
         modes=("stream", "ooc"))


@pytest.mark.parametrize("chunk", range(CHUNKS // 2))
def test_random_sparse_dag_parity(chunk, data_dirs):
    """The generator's programs over a sparse (ELL) register 0 whose
    densified values are the oracle's input, in whole mode, streamed from
    the device-tier slab, and out of core from a CSR ``.fmat``."""
    k = CHUNKS // 2
    lo = SPARSE_EXAMPLES * chunk // k
    hi = SPARSE_EXAMPLES * (chunk + 1) // k
    _run((dataclasses.replace(ref.generate(BASE_SEED + EXAMPLES + i),
                              sparse=True) for i in range(lo, hi)),
         modes=("mem", "stream", "ooc"))


@pytest.mark.parametrize("chunk", range(CHUNKS // 2))
def test_random_dag_parity_bf16(chunk):
    """The bf16 arm (fault C6's programs among them)."""
    progs = [p for p in (ref.generate(s) for s in BF16_SEEDS)
             if p.dtype == "f32"]
    k = CHUNKS // 2
    _run(progs[len(progs) * chunk // k:len(progs) * (chunk + 1) // k],
         check=check_bf16_program)


def test_sparse_arm_is_sparse_on_both_sides(data_dirs):
    """Register 0 of a sparse program is an ELL store on the device tier in
    both packages, and for the ooc cell a CSR ``.fmat`` (the same bytes),
    whose densified values are the oracle's input."""
    prog = dataclasses.replace(ref.generate(BASE_SEED), sparse=True)
    xn = ref._input(prog)
    assert 0 < np.count_nonzero(xn) < xn.size
    for side, build in ((REF, _ref_sparse_fm), (PORT, _port_sparse_fm)):
        X = build(xn, disk=False)
        assert type(X.m.store).__name__ == "SparseEllStore"
        assert X.m.store.sparse and not X.m.on_host
        np.testing.assert_array_equal(side.fm.as_np(X), xn)
        D = build(xn, disk=True)
        assert type(D.m.store).__name__ == "CsrMmapStore" and D.m.on_disk
        np.testing.assert_array_equal(side.fm.as_np(D), xn)
    assert (data_dirs["repro"] / "fuzz_sparse.fmat").read_bytes() == \
        (data_dirs["repro_torch"] / "fuzz_sparse.fmat").read_bytes()


@pytest.mark.parametrize("name", ["epilogue", "multipass", "sparse"])
def test_known_program_parity(name, data_dirs):
    """The reference's hand-pinned programs (its always-on anchors), in
    every mode: the sparse one out of core from a CSR ``.fmat``."""
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
    _run([progs[name]], modes=("mem", "stream", "ooc"))


# ---------------------------------------------------------------------------
# The meshed arm (the reference's FUZZ_MESH arm)
# ---------------------------------------------------------------------------

#: The port's meshes: one device (the reference's in-process host mesh has
#: one), and four shards on the CPU.
_PORT_MESHES = {
    1: make_host_mesh,
    4: lambda: Mesh([torch.device("cpu")] * 4, ("data",)),
}


def _meshed(side_globals, mesh_fn):
    return types.FunctionType(ref.eval_engine_meshed.__code__,
                              {**side_globals, "_host_mesh": mesh_fn})


def check_meshed_program(prog, mode: str, port_shards: int) -> str | None:
    """One program through ``eval_engine_meshed`` in both packages, each
    against the oracle (normalized error ≤ 2e-3, the reference's limit);
    over one shard the port's counters also equal the reference's."""
    refs = ref.eval_numpy(prog)
    names = ("shards", "shard_merges") + COUNTERS
    got = []
    for side, lazy, backend, mesh_fn in (
            (REF, _ref_lazy_outputs, "xla", ref._host_mesh),
            (PORT, _port_lazy_outputs, "torch", _PORT_MESHES[port_shards])):
        run = _meshed(lazy.__globals__ | {"_lazy_outputs": lazy}, mesh_fn)
        with counting(side, names) as c:
            vals = run(prog, backend, mode)
        got.append(c)
        for o, v, want in zip(prog.outputs, vals, refs, strict=True):
            if v.shape != want.shape:
                return f"{side.name} r{o}: shape {v.shape} != {want.shape}"
            scale = max(1.0, float(np.max(np.abs(want))))
            err = float(np.max(np.abs(v - want))) / scale
            if not err <= 2e-3:
                return f"{side.name} r{o}: meshed err {err:.2e}"
    rc, pc = got
    if port_shards == 1 and pc != rc:
        return f"counters: port {pc}, reference {rc}"
    if not 1 <= pc["shards"] <= port_shards * pc["streams"]:
        return f"port shards {pc['shards']} over {port_shards}"
    return None


@pytest.mark.parametrize("port_shards", sorted(_PORT_MESHES))
def test_random_dag_parity_meshed(port_shards):
    """The dense programs in every mode, materialized under a mesh."""
    n = STREAM_EXAMPLES if ref.FUZZ_MESH else MESH_EXAMPLES
    for i in range(n):
        prog = ref.generate(BASE_SEED + i)
        for mode in ("mem", "stream", "ooc"):
            err = check_meshed_program(prog, mode, port_shards)
            REF.mz.clear_plan_cache()
            PORT.mz.clear_plan_cache()
            assert err is None, f"{mode}: {err}\nprogram:\n{prog!r}"


@pytest.mark.parametrize("port_shards", sorted(_PORT_MESHES))
def test_known_program_meshed_parity(port_shards):
    """The reference's always-on anchor of the meshed arm: a hand-pinned
    multi-output multipass program materialized with an explicit mesh
    matches the oracle in every mode."""
    prog = ref.Program(
        seed=2468, n=96, p=3, dtype="f32",
        ops=[
            ("colsums", 0),                # -> r1  pass-1 sink
            ("escalar", 1, "div", 2.0),    # -> r2  pass-1 epilogue
            ("sweeprow", 0, 2, "sub"),     # -> r3  PASS-2 row-local sweep
            ("sapply", 3, "abs"),          # -> r4  pass-2 chain
            ("colmaxs", 4),                # -> r5  pass-2 sink
            ("sumall", 0),                 # -> r6  independent sink
        ],
        outputs=[3, 5, 6])
    for mode in ("mem", "stream", "ooc"):
        err = check_meshed_program(prog, mode, port_shards)
        REF.mz.clear_plan_cache()
        PORT.mz.clear_plan_cache()
        assert err is None, f"{mode}: {err}"
