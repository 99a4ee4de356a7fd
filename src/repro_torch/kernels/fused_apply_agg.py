"""Fused apply→aggregate kernel on Hopper (csrc/fused_apply_agg.cu).

Replaces repro/kernels/fused_apply_agg.py:fused_apply_agg (Pallas,
`_chain_kernel`) and its `fused_summary` instance: one read of a tall (n, p)
X feeds N chains, each a pipeline of ≤16 unary VUDFs (``CHAIN_UNARIES``)
followed by a column aggregation with an f32 or exact-int32 accumulator.
Bound: reading X once — 8.4 GB, about 2.5 ms at 3.35 TB/s at the main
path's 65,608,366 × 32 f32.  The design: the chain spec becomes a small int
program on the host (opcode and value type per step, aggregation and
accumulator per chain), passed by value to the kernel; per-block partials go
to a workspace and a second launch combines them in a fixed order.  Two
bodies, chosen by ``chain_plan`` from the shape:

* p ≤ 256 (the main path), ``fm_fused_apply_agg_ring``: a block takes all
  p columns of a split's rows, bulk-copied (``cp.async.bulk``) chunk by
  chunk into an mbarrier ring of shared memory; ⌊256/p⌋ row lanes, one
  column a thread, and the chains decoded once for 16 values of a column
  (csrc/fused_apply_agg.cu's note has the design).  X must start on a
  16-byte boundary; a view that does not is copied first.
* p > 256, ``fm_fused_apply_agg``: 32-column tiles, neighbouring threads on
  neighbouring columns so a warp reads whole rows.

A bfloat16 X is widened to f32 in the kernel as it is read; int8/int16 and
float16 sources are widened exactly before the launch.  More than 8 chains
run as several calls of ≤ 8 (two CUDA launches each).  Both bodies add
lanes, blocks and splits in a fixed order: deterministic.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, ref
from .common import LAUNCH_LOCK, SM_COUNT, aligned, route, splits_for

#: Aggregations a chain can end in.
CHAIN_AGGS = ("sum", "min", "max", "count", "count_nonzero")

#: Unary VUDFs a chain may apply, in opcode order (csrc enum Op).
CHAIN_UNARIES = ("identity", "abs", "sq", "sqrt", "exp", "log", "log1p",
                 "neg", "sigmoid", "floor", "ceil", "round", "sign",
                 "cast_float32", "cast_int32", "cast_bfloat16")

#: Accumulator dtypes a chain may request.
CHAIN_ACC_DTYPES = ("float32", "int32")

SUMMARY_CHAINS = ref.SUMMARY_CHAINS

MAX_CHAINS = 8
MAX_STEPS = 16
_T_INT, _T_F32, _T_BF16 = 0, 1, 2
_TO_FLOAT = frozenset({"sqrt", "exp", "log", "log1p", "sigmoid"})

#: Launches of the CUDA kernels (the plain CPU path does not count):
#: ``launches`` counts every launch (one a group of ≤ MAX_CHAINS chains),
#: ``ring_launches`` those that ran the ring body (p ≤ RING_MAX_P).
launches = 0
ring_launches = 0

#: The ring body (csrc/fused_apply_agg.cu chain_ring_partials): the widest p
#: it takes, its threads, blocks an SM (its launch bound), ring stages, the
#: bytes a stage aims at, the values of a column a thread runs the chains on
#: at once, and the shared bytes before the ring (one mbarrier a stage).
RING_MAX_P = 256
RING_THREADS = 256
RING_BLOCKS_PER_SM = 2
RING_STAGES = 3
RING_STAGE_BYTES = 32 * 1024
RING_V = 16
RING_BARS = 64


class ChainPlan(NamedTuple):
    """The launch of one fused_apply_agg call.  body "ring": p ≤
    RING_MAX_P, chunks of chunk_rows rows bulk-copied into ``stages``
    stages of shared memory, ``lanes`` row lanes of p threads, one block a
    split of rows_per_split rows; "tile": the 32-column tile body
    (chain_partials), which reads X straight from global memory
    (chunk_rows, stages, lanes and smem_bytes 0)."""
    body: str
    splits: int
    rows_per_split: int
    chunk_rows: int
    stages: int
    lanes: int
    smem_bytes: int


def chain_plan(n: int, p: int, dtype: torch.dtype) -> ChainPlan:
    """fused_apply_agg's geometry, a function of (n, p, dtype) alone —
    ``dtype`` is the one the kernel reads (int32, float32 or bfloat16).
    The ring body's chunk is the most rows, a whole number of lanes ×
    RING_V rows (so a multiple of 16 rows: a whole number of 16 bytes of
    any source), that fit RING_STAGE_BYTES; its splits are
    RING_BLOCKS_PER_SM blocks an SM or one a chunk, whichever is fewer,
    each a whole number of chunks."""
    if p > RING_MAX_P:
        splits = splits_for(n, 512, -(-p // 32))
        return ChainPlan("tile", splits, -(-n // splits), 0, 0, 0, 0)
    elem = 2 if dtype == torch.bfloat16 else 4
    lanes = RING_THREADS // p
    unit = lanes * RING_V
    rows = max(unit, RING_STAGE_BYTES // (p * elem) // unit * unit)
    red = lanes * MAX_CHAINS * p * 4
    smem = RING_BARS + max(RING_STAGES * rows * p * elem, red)
    chunks = -(-n // rows)
    per = max(1, -(-chunks // max(1, min(RING_BLOCKS_PER_SM * SM_COUNT,
                                         chunks))))
    rps = per * rows
    splits = max(1, -(-n // rps))
    return ChainPlan("ring", splits, rps, rows, RING_STAGES, lanes, smem)


def normalize_chains(chains, acc_dtype: str = "float32"):
    """((unaries, agg, acc_dtype), ...); 2-tuples take ``acc_dtype``."""
    out = []
    for chain in chains:
        if len(chain) == 2:
            unaries, agg = chain
            acc = acc_dtype
        else:
            unaries, agg, acc = chain
        out.append((tuple(unaries), agg, acc))
    return tuple(out)


def _validate(chains):
    for unaries, agg, acc in chains:
        if agg not in CHAIN_AGGS:
            raise ValueError(f"unsupported chain aggregation {agg!r}")
        if acc not in CHAIN_ACC_DTYPES:
            raise ValueError(f"unsupported accumulator dtype {acc!r}; "
                             f"have {CHAIN_ACC_DTYPES}")
        if len(unaries) > MAX_STEPS:
            raise ValueError(f"a chain holds at most {MAX_STEPS} unaries")
        for u in unaries:
            if u not in CHAIN_UNARIES:
                raise ValueError(f"unsupported chain unary {u!r}")


def _widen(x: torch.Tensor) -> torch.Tensor:
    """Exact widening to the kernel's source types: int32, f32 and bf16."""
    if x.dtype in (torch.int8, torch.int16, torch.uint8):
        return x.to(torch.int32)
    if x.dtype == torch.float16:
        return x.to(torch.float32)
    if x.dtype in (torch.int32, torch.float32, torch.bfloat16):
        return x
    raise TypeError(f"fused_apply_agg: unsupported source dtype {x.dtype}")


def encode(chains, src_dtype: torch.dtype) -> list[int]:
    """The kernel's int program: [n_chains, src_type, then per chain nsteps,
    start_type, agg, acc_int, ops[16], types[16]] — ``types[s]`` is the
    value's type entering step s, following the reference chain's type
    changes (an int turns float at sqrt/exp/..., casts set the type).
    ``src_dtype`` is the dtype the kernel reads (int32, float32 or
    bfloat16)."""
    src_int = not src_dtype.is_floating_point
    src_type = _T_INT if src_int else (
        _T_BF16 if src_dtype == torch.bfloat16 else _T_F32)
    prog = [len(chains), src_type]
    for unaries, agg, acc in chains:
        if acc == "float32":
            t = _T_F32
        elif src_int:
            t = _T_INT
        else:
            t = _T_BF16 if src_dtype == torch.bfloat16 else _T_F32
        start = t
        ops, types = [], []
        for u in unaries:
            ops.append(CHAIN_UNARIES.index(u))
            types.append(t)
            if u == "cast_float32":
                t = _T_F32
            elif u == "cast_int32":
                t = _T_INT
            elif u == "cast_bfloat16":
                t = _T_BF16
            elif t == _T_INT and u in _TO_FLOAT:
                t = _T_F32
        pad = MAX_STEPS - len(ops)
        prog += [len(ops), start, CHAIN_AGGS.index(agg), int(acc == "int32")]
        prog += ops + [0] * pad + types + [0] * pad
    return prog


def fused_apply_agg(x: torch.Tensor, chains, *, acc_dtype: str = "float32"):
    """Column statistics of a tall (n, p) matrix in one read of X.
    ``chains``: ((unary_name, ...), agg[, acc_dtype]) entries.  Returns one
    (p,) tensor per chain in that chain's accumulator dtype."""
    global launches, ring_launches
    if acc_dtype not in CHAIN_ACC_DTYPES:
        raise ValueError(f"unsupported accumulator dtype {acc_dtype!r}; "
                         f"have {CHAIN_ACC_DTYPES}")
    chains = normalize_chains(chains, acc_dtype)
    _validate(chains)
    if x.ndim != 2:
        raise ValueError(f"fused_apply_agg: X must be 2-D, got {tuple(x.shape)}")
    xw = _widen(x)
    if route(x) == "cpu":
        return ref.fused_apply_agg_ref(xw, chains)
    xw = xw.contiguous()
    n, p = xw.shape
    plan = chain_plan(n, p, xw.dtype)
    ring = plan.body == "ring"
    if ring:
        xw = aligned(xw)
    lib = build.load("fused_apply_agg")
    stream = build.stream_handle(xw)
    outs = []
    for g in range(0, len(chains), MAX_CHAINS):
        group = chains[g:g + MAX_CHAINS]
        prog = encode(group, xw.dtype)
        prog_c = (ctypes.c_int * len(prog))(*prog)
        ws = torch.empty(plan.splits * len(group) * p, dtype=torch.int32,
                         device=xw.device)
        out = torch.empty((len(group), p), dtype=torch.int32, device=xw.device)
        if ring:
            err = lib.fm_fused_apply_agg_ring(
                xw.data_ptr(), ws.data_ptr(), out.data_ptr(), n, p,
                plan.chunk_rows, plan.stages, plan.rows_per_split,
                plan.splits, prog_c, stream)
        else:
            err = lib.fm_fused_apply_agg(xw.data_ptr(), ws.data_ptr(),
                                         out.data_ptr(), n, p, plan.splits,
                                         prog_c, stream)
        build.check(err, "fused_apply_agg")
        with LAUNCH_LOCK:
            launches += 1
            ring_launches += ring
        for c, (_, _, acc) in enumerate(group):
            outs.append(out[c] if acc == "int32" else out[c].view(torch.float32))
    return tuple(outs)


def fused_summary(x: torch.Tensor):
    """(sum, sumsq, min, max, l1, nnz), each (p,) float32."""
    return fused_apply_agg(x, SUMMARY_CHAINS)
