"""Vectorized user-defined functions (VUDFs), PyTorch port of repro.core.vudf.

Same registry, names, FLOP counts and dtype rules as the reference; every
body is a plain function over torch tensors of any shape.  Where PyTorch and
``jnp`` differ, the body follows ``jnp``:

* reductions canonicalize their result dtype (``torch.sum`` of int32 is
  int64; ``jnp.sum`` with x64 off is int32);
* ``round`` is half-to-even in both frameworks (``torch.round``);
* ``sign`` keeps ±0 and NaN as ``jnp.sign`` does (``torch.sign`` maps NaN to 0);
* ``which.min``/``which.max`` take the first index on ties (``torch.argmin``
  documents it), and ``min``/``max``/``pmin``/``pmax`` propagate NaN like
  ``jnp.minimum`` (``torch.amin``/``torch.minimum`` do).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import dtypes


# --------------------------------------------------------------------------
# VUDF descriptors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnaryVUDF:
    """uVUDF: vector -> vector of the same length."""

    name: str
    fn: Callable
    flops: float = 1.0
    dtype_rule: Optional[str] = None

    def out_dtype(self, in_dtype) -> torch.dtype:
        return _apply_rule(self.dtype_rule, dtypes.canon(in_dtype))

    def __call__(self, x):
        return self.fn(x)


@dataclasses.dataclass(frozen=True)
class BinaryVUDF:
    """bVUDF: the three forms (vv, vs, sv) realized through broadcasting."""

    name: str
    fn: Callable
    flops: float = 1.0
    dtype_rule: Optional[str] = None
    commutative: bool = False

    def out_dtype(self, a_dtype, b_dtype) -> torch.dtype:
        return _apply_rule(self.dtype_rule, dtypes.promote(a_dtype, b_dtype))

    def __call__(self, a, b):
        return self.fn(a, b)


@dataclasses.dataclass(frozen=True)
class AggVUDF:
    """Aggregation VUDF = (aggregate, combine) pair with an identity; see
    repro.core.vudf.AggVUDF for the contract."""

    name: str
    aggregate: Callable  # (block, axis, offset) -> partial
    combine: Callable    # (partial, partial) -> partial
    identity: Callable   # (shape, dtype) -> partial
    finalize: Callable = staticmethod(lambda acc: acc)
    flops: float = 1.0
    dtype_rule: Optional[str] = None

    def out_dtype(self, in_dtype) -> torch.dtype:
        return _apply_rule(self.dtype_rule, dtypes.canon(in_dtype))


def _apply_rule(rule: Optional[str], base: torch.dtype) -> torch.dtype:
    if rule is None:
        return base
    if rule == "float":
        return dtypes.to_floating(base)
    if rule == "bool":
        return torch.bool
    if rule == "index":
        return torch.int32
    return dtypes.canon(rule)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

UNARY: dict[str, UnaryVUDF] = {}
BINARY: dict[str, BinaryVUDF] = {}
AGG: dict[str, AggVUDF] = {}


def register_unary(name: str, fn, *, flops: float = 1.0,
                   dtype_rule=None) -> UnaryVUDF:
    u = UnaryVUDF(name, fn, flops, dtype_rule)
    UNARY[name] = u
    return u


def register_binary(name: str, fn, *, flops: float = 1.0, dtype_rule=None,
                    commutative: bool = False) -> BinaryVUDF:
    b = BinaryVUDF(name, fn, flops, dtype_rule, commutative)
    BINARY[name] = b
    return b


def register_agg(name: str, aggregate, combine, identity, *, finalize=None,
                 flops: float = 1.0, dtype_rule=None) -> AggVUDF:
    a = AggVUDF(name, aggregate, combine, identity,
                finalize or (lambda acc: acc), flops, dtype_rule)
    AGG[name] = a
    return a


def unary(name: str) -> UnaryVUDF:
    return UNARY[name]


def binary(name: str) -> BinaryVUDF:
    return BINARY[name]


def agg(name: str) -> AggVUDF:
    return AGG[name]


# --------------------------------------------------------------------------
# Built-in unary VUDFs
# --------------------------------------------------------------------------

def _floating(x):
    """jnp's promote-to-inexact: integers and bools become float32."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _sign(x):
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


register_unary("neg", lambda x: -x)
register_unary("abs", torch.abs)
register_unary("sq", lambda x: x * x)
register_unary("sqrt", lambda x: torch.sqrt(_floating(x)), dtype_rule="float")
register_unary("exp", lambda x: torch.exp(_floating(x)), flops=8,
               dtype_rule="float")
register_unary("log", lambda x: torch.log(_floating(x)), flops=8,
               dtype_rule="float")
register_unary("log1p", lambda x: torch.log1p(_floating(x)), flops=8,
               dtype_rule="float")
register_unary("floor", torch.floor)
register_unary("ceil", torch.ceil)
register_unary("round", torch.round)
register_unary("sign", _sign)
register_unary("not", torch.logical_not, dtype_rule="bool")
register_unary("isna", torch.isnan, dtype_rule="bool")
register_unary("sigmoid", lambda x: 1.0 / (1.0 + torch.exp(-_floating(x))),
               flops=10, dtype_rule="float")
register_unary("identity", lambda x: x, flops=0)

# Lazy-cast family (inserted by the DAG builder on dtype mismatch).  The
# 64-bit names cast to their canonical 32-bit members, as jnp does with x64
# off.
for _dt in ("bool", "int8", "int16", "int32", "int64", "bfloat16", "float32",
            "float64"):
    register_unary(
        f"cast_{_dt}",
        (lambda dt: (lambda x: x.to(dt)))(dtypes.canon(_dt)),
        flops=0,
        dtype_rule=_dt,
    )


# --------------------------------------------------------------------------
# Built-in binary VUDFs
# --------------------------------------------------------------------------

def _ifelse0(x, m):
    return torch.where(m.to(torch.bool), torch.zeros((), dtype=x.dtype,
                                                     device=x.device), x)


register_binary("add", torch.add, commutative=True)
register_binary("sub", torch.sub)
register_binary("mul", torch.mul, commutative=True)
register_binary("div", torch.true_divide, dtype_rule="float", flops=4)
register_binary("pow", torch.pow, dtype_rule="float", flops=12)
register_binary("mod", torch.remainder, flops=4)
register_binary("pmin", lambda a, b: torch.minimum(*_tensors(a, b)),
                commutative=True)
register_binary("pmax", lambda a, b: torch.maximum(*_tensors(a, b)),
                commutative=True)
register_binary("eq", lambda a, b: a == b, dtype_rule="bool", commutative=True)
register_binary("neq", lambda a, b: a != b, dtype_rule="bool",
                commutative=True)
register_binary("lt", lambda a, b: a < b, dtype_rule="bool")
register_binary("le", lambda a, b: a <= b, dtype_rule="bool")
register_binary("gt", lambda a, b: a > b, dtype_rule="bool")
register_binary("ge", lambda a, b: a >= b, dtype_rule="bool")
register_binary("and", lambda a, b: torch.logical_and(*_tensors(a, b)),
                dtype_rule="bool", commutative=True)
register_binary("or", lambda a, b: torch.logical_or(*_tensors(a, b)),
                dtype_rule="bool", commutative=True)
# The paper's missing-value workhorse (Fig. 5): ifelse0(x, mask) keeps x where
# ``mask`` is False and writes 0 where True.
register_binary("ifelse0", lambda x, m: _ifelse0(*_tensors(x, m)))
register_binary("squared_diff", lambda a, b: (a - b) * (a - b), flops=2,
                commutative=True, dtype_rule=None)
register_binary("absdiff", lambda a, b: torch.abs(a - b), flops=2,
                commutative=True)
register_binary("hamming", lambda a, b: (a != b).to(torch.float32), flops=1,
                commutative=True, dtype_rule="float32")


def _tensors(a, b):
    """Lift a python scalar operand to a 0-d tensor beside the other one
    (torch.minimum and friends take tensors only)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a, b


# --------------------------------------------------------------------------
# Built-in aggregation VUDFs
# --------------------------------------------------------------------------

def _full(shape, value, dtype, device=None):
    return torch.full(tuple(shape) if not isinstance(shape, int) else (shape,),
                      value, dtype=dtypes.canon(dtype), device=device)


def _reduce(fn):
    """``fn(block, dim)`` over ``axis`` (None = every element), result in
    its canonical dtype — the jnp reduction contract."""
    def aggregate(block, axis, offset):
        del offset
        out = fn(block) if axis is None else fn(block, axis)
        return dtypes.to_canon(out)
    return aggregate


def _sum(x, dim=None):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if (dim == 1 and x.dtype == torch.float32 and x.shape[1] > 1
            and x.device.type == "cpu"):
        # On the CPU, where the reference runs, a row's f32 sum (agg_row, a
        # semiring's reduction over k) adds its columns left to right, the
        # reference's order (XLA's up to 17 columns): torch.sum's vector
        # tree rounds a cancelling row differently, beyond an rtol-only
        # check.  On the card a column at a time would cost a launch a
        # column, and there is no reference order to match.
        acc = x.select(1, 0)
        for j in range(1, x.shape[1]):
            acc = acc + x.select(1, j)
        return acc
    return torch.sum(x) if dim is None else torch.sum(x, dim)


def _prod(x, dim=None):
    return torch.prod(x) if dim is None else torch.prod(x, dim)


def _amin(x, dim=None):
    return torch.amin(x) if dim is None else torch.amin(x, dim)


def _amax(x, dim=None):
    return torch.amax(x) if dim is None else torch.amax(x, dim)


def _any(x, dim=None):
    return torch.any(x) if dim is None else torch.any(x, dim)


def _all(x, dim=None):
    return torch.all(x) if dim is None else torch.all(x, dim)


def _combine(fn):
    def combine(a, b):
        return dtypes.to_canon(fn(*_tensors(a, b)))
    return combine


# Identities take the device of the computation from the conf (repro_torch
# .storage.registry), read at call time.
def _dev():
    from ..storage import registry  # deferred: storage imports core
    return registry.device()


register_agg("sum", _reduce(_sum), _combine(torch.add),
             lambda shape, dtype: _full(shape, 0, dtype, _dev()))

register_agg("prod", _reduce(_prod), _combine(torch.mul),
             lambda shape, dtype: _full(shape, 1, dtype, _dev()))

register_agg("min", _reduce(_amin), _combine(torch.minimum),
             lambda shape, dtype: _full(shape, _type_max(dtype), dtype,
                                        _dev()))

register_agg("max", _reduce(_amax), _combine(torch.maximum),
             lambda shape, dtype: _full(shape, _type_min(dtype), dtype,
                                        _dev()))

register_agg("any", _reduce(_any), _combine(torch.logical_or),
             lambda shape, dtype: _full(shape, False, torch.bool, _dev()),
             dtype_rule="bool")

register_agg("all", _reduce(_all), _combine(torch.logical_and),
             lambda shape, dtype: _full(shape, True, torch.bool, _dev()),
             dtype_rule="bool")

# count: aggregate != combine (paper: "For some aggregation such as count,
# aggregate and combine are different.")
register_agg(
    "count",
    lambda block, axis, offset: _reduce(_sum)(
        torch.ones_like(block, dtype=torch.int32), axis, offset),
    _combine(torch.add),
    lambda shape, dtype: _full(shape, 0, torch.int32, _dev()),
    dtype_rule="int64",
)

register_agg(
    "count_nonzero",
    lambda block, axis, offset: _reduce(_sum)(
        (block != 0).to(torch.int32), axis, offset),
    _combine(torch.add),
    lambda shape, dtype: _full(shape, 0, torch.int32, _dev()),
    dtype_rule="int64",
)


# Indexed reductions: the accumulator is a (value, index) pair.  The block
# offset makes indices global, so partitions compose.
def _arg_aggregate(val_fn, idx_fn):
    def aggregate(block, axis, offset):
        if axis is None:
            idx, val = idx_fn(block.reshape(-1)), val_fn(block)
        else:
            idx, val = idx_fn(block, axis), val_fn(block, axis)
        return (val, idx.to(torch.int32) + offset)
    return aggregate


def _arg_combine(better):
    def combine(a, b):
        av, ai = a
        bv, bi = b
        take_b = better(bv, av)
        return (torch.where(take_b, bv, av), torch.where(take_b, bi, ai))
    return combine


register_agg(
    "which.min",
    _arg_aggregate(_amin, torch.argmin),
    _arg_combine(torch.lt),
    lambda shape, dtype: (_full(shape, _type_max(dtype), dtype, _dev()),
                          _full(shape, 0, torch.int32, _dev())),
    finalize=lambda acc: acc[1],
    dtype_rule="index",
)

register_agg(
    "which.max",
    _arg_aggregate(_amax, torch.argmax),
    _arg_combine(torch.gt),
    lambda shape, dtype: (_full(shape, _type_min(dtype), dtype, _dev()),
                          _full(shape, 0, torch.int32, _dev())),
    finalize=lambda acc: acc[1],
    dtype_rule="index",
)


# Numerically-stable streaming logsumexp: accumulator is (running_max,
# running_sum_scaled).
def _lse_aggregate(block, axis, offset):
    del offset
    if axis is None:
        m = torch.amax(block)
        s = torch.sum(torch.exp(block - m))
    else:
        m = torch.amax(block, axis)
        s = torch.sum(torch.exp(block - m.unsqueeze(axis)), axis)
    return (m, s)


def _lse_combine(a, b):
    am, asum = a
    bm, bsum = b
    m = torch.maximum(am, bm)
    return (m, asum * torch.exp(am - m) + bsum * torch.exp(bm - m))


register_agg(
    "logsumexp",
    _lse_aggregate,
    _lse_combine,
    lambda shape, dtype: (_full(shape, -np.inf, dtype, _dev()),
                          _full(shape, 0, dtype, _dev())),
    finalize=lambda acc: acc[0] + torch.log(acc[1]),
    flops=10,
    dtype_rule="float",
)


def _type_max(dtype):
    dt = dtypes.canon(dtype)
    if dt.is_floating_point:
        return np.inf
    if dtypes.kind(dt) == "b":
        return True
    return np.iinfo(dtypes.name(dt)).max


def _type_min(dtype):
    dt = dtypes.canon(dtype)
    if dt.is_floating_point:
        return -np.inf
    if dtypes.kind(dt) == "b":
        return False
    return np.iinfo(dtypes.name(dt)).min
