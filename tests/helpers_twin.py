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

* the plan counters ``passes``, ``partition_steps`` and
  ``epilogue_launches`` of the call;
* the kernels the kernel backend dispatches: the ``kernel_units`` of
  ``Plan(outputs).program("pallas")`` in the reference against those of
  ``Plan(outputs).program("cuda")`` in the port;
* each output's shape and dtype (the numpy dtype too, but for bfloat16).

The values are then held to the reference test's own oracle and
tolerance, on both sides, by the calling test.
"""
from __future__ import annotations

import contextlib
import dataclasses

import pytest

from repro.core import fm as jfm
from repro.core import materialize as jmz
from repro.core.fusion import Plan as JPlan
from repro_torch.core import fm as tfm
from repro_torch.core import materialize as tmz
from repro_torch.core.fusion import Plan as TPlan

COUNTERS = ("passes", "partition_steps", "epilogue_launches")


@dataclasses.dataclass(frozen=True)
class Side:
    name: str
    fm: object
    mz: object
    Plan: type
    kernel_backend: str


REF = Side("repro", jfm, jmz, JPlan, "pallas")
PORT = Side("repro_torch", tfm, tmz, TPlan, "cuda")


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


@contextlib.contextmanager
def both_conf(**kw):
    """The same ``fm.conf`` override in both packages."""
    with jfm.conf(**kw), tfm.conf(**kw):
        yield


@contextlib.contextmanager
def counting(side: Side, names=COUNTERS):
    """Deltas of ``exec_stats()`` counters over a with-block."""
    before = side.mz.exec_stats()
    got: dict = {}
    try:
        yield got
    finally:
        after = side.mz.exec_stats()
        got.update({k: after[k] - before[k] for k in names})


def kernels(side: Side, program) -> list:
    """Kernel units the side's kernel backend lowers ``program`` to."""
    outs = program(side.fm)
    plan = side.Plan([o.m for o in outs])
    return sorted(u.kernel for u in plan.program(side.kernel_backend)
                  .kernel_units)


def both(program, *, backend: str = "torch", mode: str = "whole",
         fuse: bool = True):
    """Materialize ``program`` in both packages — the reference on
    ``xla``, the port on ``backend`` ('torch' or 'cuda') — and check the
    counters, the kernel dispatch and the outputs' shapes and dtypes.
    Returns ``(reference outputs, port outputs)`` as numpy arrays."""
    got = {}
    for side, be in ((REF, "xla"), (PORT, backend)):
        with counting(side) as c:
            outs = side.fm.materialize(*program(side.fm), mode=mode,
                                       backend=be, fuse=fuse)
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
