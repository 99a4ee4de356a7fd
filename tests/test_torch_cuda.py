"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a CUDA device and skips
without one (this is decided at run time, never at import).  On a machine
with a card and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes cover ragged row counts, column counts below, at and across the
32-wide tiles, bf16 sources, every chain unary, integer accumulators, NaN
and all-negative min/max edges, more chains than one launch takes,
k-means layouts whose centers or row tile do not fit in shared memory, xty
at thin and wide second operands, and ELL slabs with padding rows,
duplicate columns, kmax = 1 and kmax past one 32-entry chunk (up to
20,000), negative values and rows of weight 0, over one and many output
tiles, spmm_xty held to float64 exactly and bit for bit from call to call;
gram's and wgram's triangle body (p ≤ 32) and tile body (p > 32) told
apart by their launch counters, from bases off 16 bytes too; xty's thin path at every
narrow width 1..16; fused_apply_agg's ring body (p ≤ 256) and kmeans_assign's
TMA body (rows of 16 to 128 bytes) over ragged n, int32 / f32 / bf16 /
int8 sources, bases off 16 bytes, bit for bit from call to call, their
counters naming the body;
flash attention over ragged S and T (S below, equal to and above T), every
head dim the kernel is built for (80, 96, 112 and 256 among them), GQA
group factors 1, 3 and 8, causal and not, bf16 (held within one bf16 ulp
of float64) and f32, the wgmma body over many kv tiles, zero and negative
scales, unaligned bases (copied, then equal to the aligned result),
one case whose element offsets pass 2³¹, the two serving shapes of the
MoE and VLM families (GQA group 8 at head dim 128 on the wgmma body, MQA
at head dim 256 on the FMA body), and a reduced LM prefill and decode on
the card against the same on the CPU — dense, MoE (qwen3-moe, arctic) and
VLM (paligemma) — and the SSM (mamba2) and hybrid (zamba2, with and
without a tail) in float32, flash launching 0 times and once an
application of the shared block; a full-width init of two qwen3-moe
layers whose peak stays within one float32 layer leaf of their bf16
bytes; xty's 16-byte loads over
a ragged last column tile at the end of whole allocator segments.  The
train path (no kernel of its own): blockwise attention and its backward
against the grouped route, and a reduced llama's gradients (remat on and
off, two microbatches, either attention route) against the CPU's, then
three bf16 train steps that launch no kernel.

The partition prefetcher on the card, one test an invariant: a consumer
slowed on the compute stream at depth 1 and 8 against the synchronous
staging bit for bit, with no host wait on the compute thread (2, 3); no
pinned slot refilled before its copies complete, the copies on the side
stream of the engine's device (1, 4); a resident final partition served
across passes in an ``iteration_scope`` (3); a fault mid-stream with the
leak audit and an abandoned prefetcher's shutdown (5); staged memory
within (depth + 2) partitions with the device far behind the host (6).
Then ``fm.one_hot``'s host slab streamed ``ooc``: crossprod and glm
against the device slab.  Then the disk tier: ``.fmat`` sources through
the pinned ring (warm and with ``direct_io``) against the host tier bit for
bit, a ``save='disk'`` spill written from CUDA partitions against whole
mode's bytes, a CSR file's crossprod against the device slab's, and a
disk read fault with the leak audit.  Last, ``fm.batch``: a 3-member group
(colMeans, crossprod, XᵀY) from host RAM through the prefetcher at depth 1
and 4 — one stream, each member's kernel once a partition, results within
1e-6 of serial — and the same group with every member's step delayed at
depth 1, equal to the synchronous run bit for bit.  Then ``fm.serve``:
the launch counters exact under 8 threads, an Engine window equal to
``fm.batch`` bit for bit, a mid-stream join through a paced host store
with the prefetcher on and off, two concurrent groups with exact launch
counts, and a result read on a fresh stream of another thread finished.
Last, sharded execution over ``[cuda:0] × k`` (``launch.mesh.Mesh``): one
shard bit for bit with the unsharded run, two and four within tolerance of
it and bit for bit from run to run, each shard's steps on a CUDA stream of
its own (a delayed step on one shard leaves the merged result exact), an
injected staging fault in one shard with the leak audit, and
``Engine(mesh=)`` opening no mid-stream gate.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention as fa,
                                 fused_apply_agg as faa, gram as gram_mod,
                                 kmeans_assign as ka, ref, spmm,
                                 weighted_gram as wg)

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x(n, p, dtype, dev, scale=1.0):
    return torch.as_tensor(RNG.normal(size=(n, p)) * scale,
                           dtype=torch.float32).to(dtype).to(dev)


def _close(a, b, tol):
    a, b = a.double().cpu(), b.double().cpu()
    scale = max(float(b.abs().max()), 1.0)
    assert float((a - b).abs().max()) <= tol * scale


def _close_gram(g, x, w=None):
    """Entry by entry against the float64 plain version, in the units of a
    correlation (|ΔG_ij| / sqrt(G_ii·G_jj)); off-diagonal entries, whose
    terms take both signs and round far less, to a tighter limit."""
    x64 = x.double()
    g64 = (x64 if w is None else x64 * w.double()[:, None]).T @ x64
    d = g64.diagonal().clamp_min(1e-300).sqrt()
    err = (g.double() - g64).abs() / torch.outer(d, d)
    assert float(err.diagonal().max()) <= 1e-5
    off = ~torch.eye(err.shape[0], dtype=torch.bool, device=err.device)
    if off.any():
        assert float(err[off].max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 100, 1000, 70001])
@pytest.mark.parametrize("p", [1, 7, 12, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_and_wgram(dev, n, p, dtype):
    x = _x(n, p, dtype, dev)
    w = torch.rand(n, device=dev)
    before = (gram_mod.launches, wg.launches)
    _close_gram(gram_mod.gram(x), x)
    _close_gram(wg.wgram(x, w), x, w)
    _close_gram(wg.wgram(x, w.reshape(-1, 1)), x, w)
    torch.cuda.synchronize()
    assert (gram_mod.launches, wg.launches) == (before[0] + 1, before[1] + 2)


def _tri_bodies(dev, n, p, dtype, weighted):
    """gram's or wgram's triangle body (p ≤ 32: bulk-copied chunks, a
    plain-loaded tail chunk, 8×8 tiles of the upper triangle) and tile body
    (p > 32), told apart by the launch counters, against float64 in
    correlation units; an X (and w) view whose base is off a 16-byte
    boundary is copied first and gives the aligned result bit for bit; the
    triangle body's result is its own mirror, exactly."""
    mod = wg if weighted else gram_mod
    x = _x(n, p, dtype, dev)
    w = torch.rand(n, device=dev)
    x_off = _x(n * p + 1, 1, dtype, dev).reshape(-1)[1:].reshape(n, p)
    w_off = torch.rand(n + 1, device=dev)[1:]
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    if not weighted:
        w = w_off = None

    def call(a, b):
        return wg.wgram(a, b) if weighted else gram_mod.gram(a)

    tri = p <= gram_mod.TRI_MAX_P
    before = (mod.launches, mod.tri_launches)
    got = call(x, w)
    off = call(x_off, w_off)
    again = call(x_off.clone(), None if w_off is None else w_off.clone())
    torch.cuda.synchronize()
    assert (mod.launches, mod.tri_launches) == (before[0] + 3,
                                                before[1] + 3 * tri)
    _close_gram(got, x, w)
    _close_gram(off, x_off, w_off)
    assert torch.equal(off, again)
    assert torch.equal(got, got.T) or not tri


@pytest.mark.parametrize("n", [1, 3, 1000, 70001])
@pytest.mark.parametrize("p", [1, 7, 12, 31, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgram_bodies(dev, n, p, dtype):
    """wgram's two bodies (``_tri_bodies``, with the weights)."""
    _tri_bodies(dev, n, p, dtype, weighted=True)


@pytest.mark.parametrize("n", [1, 3, 1000, 70001])
@pytest.mark.parametrize("p", [1, 7, 12, 31, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_bodies(dev, n, p, dtype):
    """gram's two bodies (``_tri_bodies``, without weights): the same
    triangle kernel as wgram's, with no weights copied or multiplied."""
    _tri_bodies(dev, n, p, dtype, weighted=False)


@pytest.mark.parametrize("n", [1, 1000, 70001])
@pytest.mark.parametrize("p,q", [(8, 32), (32, 1), (33, 70), (1, 1),
                                 (16, 40), (40, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xty(dev, n, p, q, dtype):
    x, y = _x(n, p, dtype, dev), _x(n, q, dtype, dev)
    before = gram_mod.xty_launches
    got = gram_mod.xty(x, y)
    want = x.double().T @ y.double()
    torch.cuda.synchronize()
    assert gram_mod.xty_launches == before + 1 and got.shape == (p, q)
    # entry by entry in the units of sqrt(Σx_i² · Σy_j²)
    scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                        y.double().pow(2).sum(0).sqrt()).clamp_min(1e-300)
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("na", range(1, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xty_thin_widths(dev, na, dtype):
    """The thin path at every narrow width 1..16 (each served by the built
    width thin_width(na)), as X and as Y, over wide operands of 32 columns
    (16-byte loads) and 37 (scalar loads), for n below one block step (32
    rows), across a few and not a multiple of the rows a block prefetches,
    and from a base that is not 16-byte aligned; entry by entry against
    float64 in the units of sqrt(Σx_i² · Σy_j²)."""
    for n in (5, 1000, 70001):
        for nw in (32, 37):
            narrow = _x(n, na, dtype, dev)
            wide = _x(n * nw + 1, 1, dtype, dev).reshape(-1)[1:].reshape(n, nw)
            for x, y in ((narrow, wide), (wide, narrow)):
                before = gram_mod.xty_launches
                got = gram_mod.xty(x, y)
                torch.cuda.synchronize()
                assert gram_mod.xty_launches == before + 1
                want = x.double().T @ y.double()
                scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                                    y.double().pow(2).sum(0).sqrt())
                err = (got.double() - want).abs() / scale.clamp_min(1e-300)
                assert got.shape == want.shape and float(err.max()) <= 1e-5


@pytest.mark.parametrize("nw", [36, 40, 44])
@pytest.mark.parametrize("na", [1, 8])
def test_xty_thin_vector_loads_stop_at_the_last_column(dev, nw, na):
    """The thin path's 16-byte loads with nw a multiple of 4 but not of 32:
    the last column tile is ragged, its threads past nw load nothing.  The
    wide operand is 131,072 rows, 18, 20 or 22 MiB: whole 2 MiB segments of
    the caching allocator, so a read past its end would leave its
    allocation."""
    n = 131_072
    assert (n * nw * 4) % (2 << 20) == 0
    narrow, wide = _x(n, na, torch.float32, dev), _x(n, nw, torch.float32, dev)
    for x, y in ((narrow, wide), (wide, narrow)):
        before = gram_mod.xty_launches
        got = gram_mod.xty(x, y)
        torch.cuda.synchronize()
        assert gram_mod.xty_launches == before + 1
        want = x.double().T @ y.double()
        scale = torch.outer(x.double().pow(2).sum(0).sqrt(),
                            y.double().pow(2).sum(0).sqrt())
        err = (got.double() - want).abs() / scale.clamp_min(1e-300)
        assert got.shape == want.shape and float(err.max()) <= 1e-5


def _ell(n, kmax, ncol, dev, dtype=torch.float32):
    """A random slab with all-padding rows, rows with padding at the end and
    duplicate columns inside rows."""
    cols = torch.as_tensor(RNG.integers(0, ncol, size=(n, kmax)),
                           dtype=torch.int32)
    vals = torch.as_tensor(RNG.uniform(0.5, 1.5, size=(n, kmax)),
                           dtype=torch.float32)
    pad = torch.as_tensor(RNG.uniform(size=(n, kmax)) < 0.2)
    pad[::7] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if kmax > 1 and n > 3:
        cols[3, 1] = cols[3, 0]
    return cols.to(dev), vals.to(dtype).to(dev)


@pytest.mark.parametrize("n", [1, 255, 5000])
@pytest.mark.parametrize("kmax,ncol", [(1, 5), (3, 23), (26, 300), (40, 1664)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm(dev, n, kmax, ncol, dtype):
    cols, vals = _ell(n, kmax, ncol, dev, dtype)
    w = torch.rand(n, device=dev) * 0.25
    y = _x(n, 3, torch.float32, dev)
    before = (spmm.gram_launches, spmm.xty_launches, spmm.wgram_launches)
    got = (spmm.spmm_gram(cols, vals, ncol=ncol),
           spmm.spmm_xty(cols, vals, y, ncol=ncol),
           spmm.spmm_wgram(cols, vals, w.reshape(-1, 1), ncol=ncol))
    want = (ref.spmm_gram_ref(cols, vals, ncol, torch.float64),
            ref.spmm_xty_ref(cols, vals, y, ncol, torch.float64),
            ref.spmm_wgram_ref(cols, vals, w, ncol, torch.float64))
    torch.cuda.synchronize()
    assert (spmm.gram_launches, spmm.xty_launches, spmm.wgram_launches) == \
        tuple(b + 1 for b in before)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == torch.float32
        _close(g, r, 1e-5)


@pytest.mark.parametrize("kmax", [1, 3, 26, 33, 40, 20000])
def test_spmm_gram_warp_per_row_body(dev, kmax):
    """The gram / wgram body over one 32-entry chunk, a chunk and a bit, and
    625 chunks a row (kmax = 20,000, wider than xty's staging takes): 64
    rows, ncol = 1,664 (28 tiles), duplicate columns, negative values, and
    rows of weight 0, against the float64 plain version."""
    n, ncol = 64, 1664
    cols, vals = _ell(n, kmax, ncol, dev)
    cols[5, :64] = int(cols[5, 0])              # one column, up to 64 times
    # Values in ±{0.5, 1, 1.5}: every f32 partial sum is exact, so the
    # kernel must hit float64 whatever the order of its atomics.
    vals = (vals * 2).round() / 2 * torch.where(
        torch.rand(vals.shape, device=dev) < 0.3, -1.0, 1.0)
    w = torch.rand(n, device=dev)
    w[::3] = 0.0
    before = (spmm.gram_launches, spmm.wgram_launches)
    got = (spmm.spmm_gram(cols, vals, ncol=ncol),
           spmm.spmm_wgram(cols, vals, w, ncol=ncol))
    torch.cuda.synchronize()
    assert (spmm.gram_launches, spmm.wgram_launches) == tuple(
        b + 1 for b in before)
    for g, r in zip(got, (ref.spmm_gram_ref(cols, vals, ncol, torch.float64),
                          ref.spmm_wgram_ref(cols, vals, w, ncol,
                                             torch.float64))):
        assert g.shape == (ncol, ncol) and g.dtype == torch.float32
        _close(g, r, 1e-5)


def _halves(shape, dev):
    """Values in ±{0.5, 1, 1.5}: products and sums of a few thousand of
    them are exact in f32, whatever the order."""
    v = torch.as_tensor(RNG.integers(1, 4, size=shape) / 2.0,
                        dtype=torch.float32)
    return (v * torch.where(torch.as_tensor(RNG.uniform(size=shape)) < 0.3,
                            -1.0, 1.0)).to(dev)


@pytest.mark.parametrize("kmax", [1, 3, 26, 33, 40, 20000])
@pytest.mark.parametrize("q", [1, 3, 32])
def test_spmm_xty_warp_per_row_body(dev, kmax, q):
    """The xty body over one 32-entry chunk, a chunk and a bit, and 625
    chunks a row (kmax = 20,000, which the old staged body could not take),
    ncol = 1,664: even rows one-hot-like (each 32-entry chunk distinct
    columns in increasing order, some padded at the end: the vote's fast
    path), odd rows drawn at random (unsorted, duplicate columns: the
    __match_any_sync path), one row a single column up to 64 times, padding
    between entries, negative values.  Every product and partial sum is
    exact in f32, so the kernel must equal float64, and two calls must be
    equal bit for bit."""
    n, ncol = (64 if kmax > 40 else 3000), 1664
    cols = torch.as_tensor(RNG.integers(0, ncol, size=(n, kmax)),
                           dtype=torch.int32)
    for r in range(0, n, 2):
        for a0 in range(0, kmax, 32):
            k = min(32, kmax - a0)
            cols[r, a0:a0 + k] = torch.as_tensor(
                np.sort(RNG.choice(ncol, size=k, replace=False)))
    vals = _halves((n, kmax), "cpu")
    tail = torch.as_tensor(RNG.uniform(size=n) < 0.3)[:, None] & (
        torch.arange(kmax) >= max(1, kmax - 5))
    mid = torch.as_tensor(RNG.uniform(size=(n, kmax)) < 0.05)
    mid[::2] = False
    pad = tail | mid
    cols[pad] = 0
    vals[pad] = 0.0
    cols[5, :64] = int(cols[5, 0])              # one column, up to 64 times
    cols, vals = cols.to(dev), vals.to(dev)
    y = _halves((n, q), dev)
    before = spmm.xty_launches
    got = spmm.spmm_xty(cols, vals, y, ncol=ncol)
    again = spmm.spmm_xty(cols, vals, y, ncol=ncol)
    torch.cuda.synchronize()
    assert spmm.xty_launches == before + 2
    want = ref.spmm_xty_ref(cols, vals, y, ncol, torch.float64)
    assert got.shape == (ncol, q) and got.dtype == torch.float32
    assert torch.equal(got.double(), want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("q", [1, 40])
def test_spmm_criteo_layout(dev, q):
    """The main path's tiling (ncol = 1664, kmax = 26: 28 triangle tiles of
    240, a warp a row; xty in one or several column stripes) on 20,000
    rows."""
    cols = torch.as_tensor(
        RNG.integers(0, 64, size=(20000, 26)) + 64 * np.arange(26),
        dtype=torch.int32).to(dev)
    vals = torch.ones(cols.shape, device=dev)
    w = torch.rand(20000, device=dev) * 0.25
    y = _x(20000, q, torch.float32, dev)
    _close(spmm.spmm_gram(cols, vals, ncol=1664),
           ref.spmm_gram_ref(cols, vals, 1664, torch.float64), 1e-6)
    _close(spmm.spmm_wgram(cols, vals, w, ncol=1664),
           ref.spmm_wgram_ref(cols, vals, w, 1664, torch.float64), 1e-5)
    _close(spmm.spmm_xty(cols, vals, y, ncol=1664),
           ref.spmm_xty_ref(cols, vals, y, 1664, torch.float64), 1e-5)


_ALL_UNARY_CHAINS = tuple(((u,), "sum", "float32")
                          for u in faa.CHAIN_UNARIES
                          if u not in ("log", "sqrt", "log1p"))


@pytest.mark.parametrize("n", [1, 257, 5000])
@pytest.mark.parametrize("p", [1, 12, 32, 45])
def test_fused_apply_agg_float_chains(dev, n, p):
    x = _x(n, p, torch.float32, dev, scale=3.0)
    xa = x.abs() + 0.5          # domain of log/sqrt/log1p
    chains = ref.SUMMARY_CHAINS + _ALL_UNARY_CHAINS
    for src, spec in ((x, chains),
                      (xa, ((("log",), "sum"), (("sqrt", "exp"), "max"),
                            (("log1p", "round"), "min")))):
        spec = faa.normalize_chains(spec)
        got = faa.fused_apply_agg(src, spec)
        want = ref.fused_apply_agg_ref(src, spec)
        for (u, agg, _), a, b in zip(spec, got, want):
            if agg in ("min", "max", "count", "count_nonzero"):
                assert torch.equal(a, b), (u, agg)
            else:
                _close(a, b, 1e-5)


def test_fused_apply_agg_int_and_cast_chains(dev):
    a = torch.as_tensor(RNG.integers(-50, 50, size=(3001, 5)),
                        dtype=torch.int32).to(dev)
    a[0, 0] = (1 << 24) + 1     # not representable in float32
    chains = ((("sq",), "sum", "int32"), ((), "max", "int32"),
              ((), "min", "int32"), (("abs", "neg"), "sum", "int32"),
              (("abs", "cast_float32", "sqrt"), "sum", "float32"),
              (("abs", "sqrt"), "max", "int32"), (("cast_bfloat16", "sq"), "sum",
                                            "float32"),
              ((), "count", "int32"), ((), "count_nonzero", "int32"))
    got = faa.fused_apply_agg(a, chains)
    want = ref.fused_apply_agg_ref(a, faa.normalize_chains(chains))
    for (u, agg, acc), g, w in zip(chains, got, want):
        assert g.dtype == w.dtype
        if acc == "int32":
            assert torch.equal(g, w), (u, agg)
        else:
            _close(g, w, 1e-5)
    assert int(got[1][0]) == (1 << 24) + 1


def test_fused_apply_agg_nan_negative_and_narrow_sources(dev):
    x = -torch.rand(700, 4, device=dev) - 1.0     # all negative
    x[3, 1] = float("nan")
    mx, mn, s = faa.fused_apply_agg(x, (((), "max"), ((), "min"),
                                        ((), "sum")))
    assert torch.isnan(mx[1]) and torch.isnan(mn[1]) and torch.isnan(s[1])
    keep = [0, 2, 3]
    assert torch.equal(mx[keep], x[:, keep].amax(0))
    assert torch.equal(mn[keep], x[:, keep].amin(0))
    x8 = torch.as_tensor(RNG.integers(-100, 100, size=(999, 3)),
                         dtype=torch.int8).to(dev)
    (s8,) = faa.fused_apply_agg(x8, (((), "sum", "int32"),))
    assert torch.equal(s8, x8.to(torch.int32).sum(0, dtype=torch.int32))
    chains = faa.normalize_chains(ref.SUMMARY_CHAINS + (
        (("sq",), "count_nonzero", "int32"), (("exp",), "sum"),
        (("abs",), "max", "int32")))
    for dtype in (torch.bfloat16, torch.float16):   # read in the kernel / widened first
        xb = _x(999, 6, dtype, dev)
        for (u, agg, _), g, w in zip(chains, faa.fused_apply_agg(xb, chains),
                                     ref.fused_apply_agg_ref(faa._widen(xb),
                                                             chains)):
            if agg in ("min", "max", "count_nonzero"):
                assert torch.equal(g, w), (dtype, u, agg)
            else:
                _close(g, w, 1e-4)


#: The chain specs of tests/test_torch_kernels.py's _CHAIN_CASES (that file
#: imports jax, which the card's machine need not have), by the source they
#: take: int sources the int-accumulator and cast chains (10 chains, two
#: launches), float sources summary's six, every float unary (12) and the
#: domain-restricted ones (21 chains, three launches).
_INT_CHAINS = faa.normalize_chains((
    ((), "sum", "int32"), (("sq",), "sum", "int32"),
    (("abs", "neg"), "min", "int32"), ((), "max", "int32"),
    ((), "count", "int32"), ((), "count_nonzero", "int32"),
    (("cast_float32", "sqrt"), "sum", "float32"),
    (("cast_float32", "sq"), "max", "float32"),
    (("cast_bfloat16", "sq"), "sum", "float32"),
    (("abs", "sqrt", "cast_int32"), "sum", "int32")))
_FLOAT_CHAINS = faa.normalize_chains(ref.SUMMARY_CHAINS + tuple(
    ((u,), "sum") for u in (
        "identity", "abs", "sq", "exp", "neg", "sigmoid", "floor", "ceil",
        "round", "sign", "cast_float32", "cast_bfloat16")) + (
    (("abs", "sqrt"), "sum"), (("abs", "log1p"), "max"),
    (("abs", "exp", "log"), "min")))


def _ring_source(n, p, dtype, dev):
    """A seeded (n, p) source: ints in [-60, 60) (int8 too), or floats
    N(0, 9) with column 0 all negative and, at p > 1, a NaN in column 1."""
    if dtype in (torch.int32, torch.int8):
        return torch.as_tensor(RNG.integers(-60, 60, size=(n, p)),
                               dtype=dtype).to(dev)
    x = _x(n, p, torch.float32, dev, scale=3.0)
    x[:, 0] = -x[:, 0].abs() - 0.5
    if p > 1:
        x[n // 2, 1] = float("nan")
    return x.to(dtype)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_or_close(u, agg, acc, got, want):
    """min, max, counts and int32 sums exact (NaN where the plain version
    has NaN), float sums within 1e-5 of the largest |entry|."""
    nan = torch.isnan(want) if want.is_floating_point() else None
    if nan is not None:
        assert torch.equal(torch.isnan(got), nan), (u, agg)
        got, want = got[~nan], want[~nan]
    if agg in ("min", "max", "count", "count_nonzero") or acc == "int32":
        assert torch.equal(got, want), (u, agg, acc)
    elif want.numel():
        _close(got, want, 1e-5)


@pytest.mark.parametrize("n", [1, 7, 1000, 70001])
@pytest.mark.parametrize("p", [1, 5, 12, 32, 33, 100, 256, 257])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.int8])
def test_fused_apply_agg_ring_body(dev, n, p, dtype):
    """The ring body (p ≤ 256; p = 257 stays on the tile body) against the
    plain version: every chain spec of the CPU tests, more than 8 chains a
    call, NaN and all-negative columns; two calls equal bit for bit, and
    the counters name the body that ran."""
    x = _ring_source(n, p, dtype, dev)
    chains = _FLOAT_CHAINS if x.is_floating_point() else _INT_CHAINS
    launches = -(-len(chains) // faa.MAX_CHAINS)
    before = (faa.launches, faa.ring_launches)
    got = faa.fused_apply_agg(x, chains)
    again = faa.fused_apply_agg(x, chains)
    torch.cuda.synchronize()
    ring = faa.chain_plan(n, p, faa._widen(x).dtype).body == "ring"
    assert ring == (p <= faa.RING_MAX_P)
    assert (faa.launches, faa.ring_launches) == (
        before[0] + 2 * launches, before[1] + 2 * launches * ring)
    want = ref.fused_apply_agg_ref(faa._widen(x), chains)
    for (u, agg, acc), g, a, w in zip(chains, got, again, want):
        assert g.dtype == w.dtype and g.shape == (p,)
        assert torch.equal(_bits(g), _bits(a)), (u, agg)
        _same_or_close(u, agg, acc, g, w)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
def test_fused_apply_agg_ring_unaligned_view(dev, dtype):
    """A view whose base is off a 16-byte boundary (what cp.async.bulk
    needs) is copied first: the same bits as the aligned source."""
    n, p = 1000, 32
    x = _ring_source(n, p, dtype, dev)
    buf = torch.zeros(n * p + 1, dtype=dtype, device=dev)
    view = buf[1:].view(n, p)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    chains = _FLOAT_CHAINS if x.is_floating_point() else _INT_CHAINS
    for g, w in zip(faa.fused_apply_agg(view, chains),
                    faa.fused_apply_agg(x, chains)):
        assert torch.equal(_bits(g), _bits(w))


def _check_lloyd(x, c):
    lab, sums, cnts, wss = ka.kmeans_assign(x, c)
    rl, rs, rc, rw = ref.kmeans_assign_ref(x, c)
    bad = (lab != rl).nonzero().reshape(-1)
    if bad.numel():
        xb, cd = x[bad].double(), c.double()
        da = ((xb - cd[lab[bad].long()]) ** 2).sum(1)
        dr = ((xb - cd[rl[bad].long()]) ** 2).sum(1)
        assert bool(((da - dr).abs()
                     <= 1e-5 * torch.maximum(da, dr).clamp_min(1.0)).all())
    assert float((cnts - rc).abs().sum()) <= 2 * bad.numel()
    _close(sums, rs, 1e-4)
    _close(wss, rw, 1e-4)


@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("k,p", [(2, 3), (5, 8), (10, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign(dev, n, k, p, dtype):
    x = _x(n, p, dtype, dev)
    c = _x(k, p, torch.float32, dev)
    _check_lloyd(x, c)


@pytest.mark.parametrize("k,p", [(900, 64), (3, 300), (60000, 1)])
def test_kmeans_assign_global_layouts(dev, k, p):
    """Centers (900·64·4 B), the row tile (256·301·4 B) or even ‖c‖²
    (60000·4 B) too large for shared memory: read from global memory
    instead, same results."""
    x = _x(3000, p, torch.float32, dev)
    c = _x(k, p, torch.float32, dev)
    _check_lloyd(x, c)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70001])
@pytest.mark.parametrize("k", [1, 2, 10, 64, 500])
@pytest.mark.parametrize("p", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_tma_body(dev, n, k, p, dtype):
    """The TMA body (rows of 16 to 128 bytes; bf16 p = 4, 8 bytes, stays on
    the staged body) against the plain version, with two centers equal
    (ties go to the first index); two calls equal bit for bit, and the
    counters name the body that ran."""
    x = _x(n, p, dtype, dev)
    c = _x(k, p, torch.float32, dev)
    if k > 2:
        c[k - 1] = c[1]
    tma = ka.lloyd_plan(n, p, k, dtype).body == "tma"
    assert tma == (p * x.element_size() % 16 == 0)
    before = (ka.launches, ka.tma_launches)
    first = ka.kmeans_assign(x, c)
    second = ka.kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert (ka.launches, ka.tma_launches) == (before[0] + 2,
                                              before[1] + 2 * tma)
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))
    if k > 2:
        assert not bool((first[0] == k - 1).any())
    _check_lloyd(x, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_tma_partials_in_workspace(dev, dtype):
    """k = 1000 at p = 32: the centers fit beside the ring but no lane of
    partials does, so the TMA body gathers into the block's workspace."""
    n, p, k = 3000, 32, 1000
    plan = ka.lloyd_plan(n, p, k, dtype)
    assert plan.body == "tma" and not plan.part_smem
    x = _x(n, p, dtype, dev)
    c = _x(k, p, torch.float32, dev)
    before = ka.tma_launches
    _check_lloyd(x, c)
    assert ka.tma_launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_assign_tma_unaligned_view(dev, dtype):
    """A view off a 16-byte boundary (a TMA base must be on one) is copied
    first: the same bits as the aligned source."""
    n, p, k = 1000, 32, 10
    x = _x(n, p, dtype, dev)
    buf = torch.zeros(n * p + 1, dtype=dtype, device=dev)
    view = buf[1:].view(n, p)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    c = _x(k, p, torch.float32, dev)
    for a, b in zip(ka.kmeans_assign(view, c), ka.kmeans_assign(x, c)):
        assert torch.equal(_bits(a), _bits(b))


def test_engine_reaches_every_kernel_on_cuda(dev):
    """The four algorithms on the card with backend cuda launch each kernel
    and agree with backend torch."""
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    X = (RNG.normal(size=(20000, 8)) * 2 + 1).astype(np.float32)
    beta = RNG.uniform(-1, 1, 8)
    y = (RNG.uniform(size=20000) < 1 / (1 + np.exp(-(X - 1) @ beta))
         ).astype(np.float32)
    mods = (gram_mod, wg, faa, ka)
    res = {}
    with fm.conf(device="cuda"):
        for backend in ("cuda", "torch"):
            before = [m.launches for m in mods]
            with fm.conf(backend=backend):
                Xf, yf = fm.conv_R2FM(X), fm.conv_R2FM(y)
                res[backend] = (summary(Xf), correlation(Xf),
                                glm(Xf, yf, max_iter=8),
                                kmeans(Xf, k=4, max_iter=3))
            grew = [m.launches > b for m, b in zip(mods, before)]
            assert all(grew) if backend == "cuda" else not any(grew)
    s, c, g, k = res["cuda"]
    s2, c2, g2, k2 = res["torch"]
    np.testing.assert_allclose(s.mean, s2.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.col_min, s2.col_min)
    np.testing.assert_allclose(c, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.beta, g2.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(k.wss, k2.wss, rtol=1e-3)


def test_engine_reaches_xty_and_spmm_on_cuda(dev):
    """NMF and GMM reach xty (and gram, wgram), sparse logistic regression
    and crossprod over a one-hot design reach the three SpMM kernels; each
    agrees with backend torch."""
    from repro_torch.algorithms import glm, gmm, nmf
    from repro_torch.core import fm
    centers = RNG.normal(size=(3, 6)) * 8
    X = np.concatenate([c + RNG.normal(size=(3000, 6)) for c in centers]
                       ).astype(np.float32)
    codes = [RNG.integers(0, lv, 9000) for lv in (7, 5, 11)]
    yb = (RNG.uniform(size=9000) < 0.3).astype(np.float32)
    counters = ((gram_mod, "xty_launches"), (spmm, "gram_launches"),
                (spmm, "xty_launches"), (spmm, "wgram_launches"))
    res = {}
    with fm.conf(device="cuda"):
        for backend in ("cuda", "torch"):
            before = [getattr(m, a) for m, a in counters]
            with fm.conf(backend=backend):
                Xf = fm.conv_R2FM(X)
                Xs = fm.one_hot(*[fm.as_factor(c) for c in codes], host=False)
                (G,) = fm.materialize(fm.crossprod(Xs))
                res[backend] = (nmf(fm.conv_R2FM(np.abs(X)), k=3,
                                    max_iter=4),
                                gmm(Xf, k=3, max_iter=4, seed=1),
                                glm(Xs, fm.conv_R2FM(yb), ridge=1e-3),
                                fm.as_np(G))
            grew = [getattr(m, a) > b for (m, a), b in zip(counters, before)]
            assert all(grew) if backend == "cuda" else not any(grew)
    (n1, g1, l1, G1), (n2, g2, l2, G2) = res["cuda"], res["torch"]
    np.testing.assert_allclose(n1.objective_trace, n2.objective_trace,
                               rtol=1e-4)
    np.testing.assert_allclose(g1.loglik_trace, g2.loglik_trace, rtol=1e-5)
    np.testing.assert_allclose(l1.loglik, l2.loglik, rtol=1e-5)
    np.testing.assert_array_equal(G1, G2)


_ATTN_LENGTHS = [(1, 1), (37, 37), (100, 100), (130, 70), (70, 200),
                 (257, 257)]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, d, g, causal, dtype):
    """Against the float64 plain version (the Pallas kernel's function: top-
    left causal mask by absolute ids): f32 within 1e-4 of max(|O|, 1), bf16
    within 1e-2 (one bf16 rounding of the output)."""
    B, nkv = 2, 2
    for S, T in _ATTN_LENGTHS:
        q = _x(B * nkv * g * S, d, dtype, dev).reshape(B, nkv * g, S, d)
        k = _x(B * nkv * T, d, dtype, dev).reshape(B, nkv, T, d)
        v = _x(B * nkv * T, d, dtype, dev).reshape(B, nkv, T, d)
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       dtype=torch.float64)
        _close(got, want, 1e-4 if dtype == torch.float32 else 1e-2)
        if dtype == torch.bfloat16:
            _within_one_ulp(got, want)


def _within_one_ulp(got, want):
    """bf16 output within one bf16 ulp, 1e-5 + 2⁻⁷·|o64|, of the float64
    plain version, element by element (chip_smoke.py's rule): a kernel that
    rounded P to bf16 once would miss it."""
    want = want.double().cpu()
    excess = (got.double().cpu() - want).abs() - 1e-5 - 2.0 ** -7 * want.abs()
    assert float(excess.max()) <= 0


@pytest.mark.parametrize("S,T,d,g,causal", [
    (1024, 1024, 128, 3, True), (1024, 1024, 128, 3, False),
    (1024, 1024, 64, 3, True), (1000, 1000, 128, 1, True),
    (300, 1000, 64, 8, False), (50, 50, 128, 3, True), (50, 300, 64, 1, False),
    (200, 130, 128, 3, True), (1500, 1500, 64, 1, False),
    (416, 1500, 64, 1, False), (416, 416, 64, 1, True)])
def test_flash_attention_hopper_body(dev, S, T, d, g, causal):
    """The wgmma body (bf16, head dims 64 and 128) across many kv tiles and
    wrap-arounds of its ring (2 stages at d 128, 4 at d 64; T = 1024 is 8
    tiles of 128 keys), T not a multiple of the 128-key tile, S below one
    64-row warpgroup and below the 128-row block, and whisper-medium's
    three shapes (the encoder's 1500 × 1500 and the cross-attention's 416
    × 1500, not causal; the decoder's 416 × 416, causal — 1500 and 416
    multiples of neither tile): one launch, within one bf16 ulp of
    float64."""
    assert fa.body_for(torch.bfloat16, d) == "wgmma"
    B, nkv = 2, 2
    q = _x(B * nkv * g * S, d, torch.bfloat16, dev).reshape(B, nkv * g, S, d)
    k = _x(B * nkv * T, d, torch.bfloat16, dev).reshape(B, nkv, T, d)
    v = _x(B * nkv * T, d, torch.bfloat16, dev).reshape(B, nkv, T, d)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   dtype=torch.float64)
    _close(got, want, 1e-2)
    _within_one_ulp(got, want)


def test_flash_attention_matched_heads_and_scale(dev):
    """The Pallas kernel's own layout (BH, S, D) and an explicit scale."""
    q = _x(3 * 150, 64, torch.float32, dev).reshape(3, 150, 64)
    k = _x(3 * 90, 64, torch.float32, dev).reshape(3, 90, 64)
    v = _x(3 * 90, 64, torch.float32, dev).reshape(3, 90, 64)
    for causal in (True, False):
        _close(fa.flash_attention(q, k, v, causal=causal, scale=0.3),
               ref.flash_attention_ref(q, k, v, causal=causal, scale=0.3,
                                       dtype=torch.float64), 1e-4)


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (64, torch.bfloat16),
                                     (32, torch.bfloat16), (64, torch.float32)])
@pytest.mark.parametrize("scale", [0.0, -0.3])
def test_flash_attention_zero_and_negative_scale(dev, d, dtype, scale):
    """Both bodies mask after the scale: at scale 0 a row averages its
    unmasked values, at a negative scale the masked keys still drop out;
    bf16 within one bf16 ulp of float64, f32 within 1e-4."""
    B, nh, nkv, S = 2, 6, 2, 300
    q = _x(B * nh * S, d, dtype, dev).reshape(B, nh, S, d)
    k = _x(B * nkv * S, d, dtype, dev).reshape(B, nkv, S, d)
    v = _x(B * nkv * S, d, dtype, dev).reshape(B, nkv, S, d)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       dtype=torch.float64)
        if dtype == torch.bfloat16:
            _within_one_ulp(got, want)
        else:
            _close(got, want, 1e-4)


def test_flash_attention_unaligned_base_raises(dev):
    """A contiguous view that starts off a 16-byte boundary (both bodies read
    16 bytes at a time; TMA takes no other base) is copied to a fresh buffer
    and computes, one launch, equal to the same values from an aligned
    base — it no longer raises."""
    for dtype, d in ((torch.bfloat16, 128), (torch.bfloat16, 32),
                     (torch.float32, 64), (torch.float32, 112)):
        flat = _x(2 * 100 * d + 1, 1, dtype, dev).reshape(-1)
        q = flat[1:].reshape(2, 100, d)
        assert q.data_ptr() % 16
        k = v = _x(2 * 100, d, dtype, dev).reshape(2, 100, d)
        for args, aligned in (((q, k, v), (q.clone(), k, v)),
                              ((k, q, v), (k, q.clone(), v)),
                              ((k, k, q), (k, k, q.clone()))):
            before = fa.launches
            got = fa.flash_attention(*args)
            torch.cuda.synchronize()
            assert fa.launches == before + 1
            assert torch.equal(got, fa.flash_attention(*aligned))


def test_flash_attention_offsets_past_2_31(dev):
    """16,448 heads × 1024 rows × 128: q has 2.16e9 elements, so the last
    heads sit past 2³¹ elements; they agree with the plain version."""
    bh, S, d = 16448, 1024, 128
    assert bh * S * d > 2 ** 31
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q, k, v = (torch.randn((bh, S, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    for h in (slice(0, 4), slice(bh - 4, bh)):
        want = ref.flash_attention_ref(q[h], k[h], v[h], causal=True,
                                       dtype=torch.float64)
        _close(out[h], want, 1e-2)
        _within_one_ulp(out[h], want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-0.5b"])
@pytest.mark.parametrize("serve_dtype,tol", [("float32", 1e-4),
                                             ("bfloat16", 2e-2)])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(dev, arch,
                                                         serve_dtype, tol):
    """A reduced model's prefill (one kernel launch a layer) and a decode
    step on the card against the same parameters on the CPU, where the
    attention is the kernel's plain version; float32 to 1e-4 of the largest
    logit, bf16 serving parameters and activations to 2e-2."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              dtype=serve_dtype)
    on = {d: steps.serving_model(cfg, serve_dtype=serve_dtype, device=d)
          for d in ("cpu", dev)}
    params = {"cpu": on["cpu"].init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 101)),
                           dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        before = fa.launches
        cache, logits = steps.build_prefill_step(on[d], 110)(
            params[d], {"tokens": toks[:, :100].to(d)})
        _, dec = steps.build_decode_step(on[d])(params[d], cache,
                                                toks[:, 100:].to(d))
        launched = fa.launches - before
        assert launched == (cfg.n_layers if d == dev else 0)
        out[d] = (logits, dec, cache["kv"]["k"])
    for a, b in zip(out[dev], out["cpu"]):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("nh,nkv,d", [(32, 4, 128), (8, 1, 256)])
def test_flash_attention_moe_and_vlm_serving_shapes(dev, nh, nkv, d):
    """qwen3-moe's attention (32 heads over 4, head dim 128: the wgmma
    body) and paligemma's (8 heads over 1, head dim 256: the FMA body) at
    S = T = 1024, bf16, causal: one launch, within one bf16 ulp of the
    float64 plain version."""
    B, S = 2, 1024
    q = _x(B * nh * S, d, torch.bfloat16, dev).reshape(B, nh, S, d)
    k = _x(B * nkv * S, d, torch.bfloat16, dev).reshape(B, nkv, S, d)
    v = _x(B * nkv * S, d, torch.bfloat16, dev).reshape(B, nkv, S, d)
    assert fa.body_for(q.dtype, d) == ("wgmma" if d == 128 else "fma")
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, dtype=torch.float64)
    _close(got, want, 1e-2)
    _within_one_ulp(got, want)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "paligemma-3b"])
@pytest.mark.parametrize("serve_dtype,tol", [("float32", 1e-4),
                                             ("bfloat16", 2e-2)])
def test_moe_and_vlm_prefill_and_decode_on_the_card_match_the_cpu(
        dev, arch, serve_dtype, tol):
    """The reduced MoE and VLM models (dropless prompts; paligemma with 8
    patch embeddings before the text) as the dense test above: prefill
    (one kernel launch a layer) and a decode step on the card against the
    CPU, float32 to 1e-4 of the largest logit, bf16 to 2e-2; the routes of
    the two devices' prefills are printed as the tokens whose top-k sets
    differ."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import moe, zoo
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              dtype=serve_dtype)
    on = {d: steps.serving_model(cfg, serve_dtype=serve_dtype, device=d)
          for d in ("cpu", dev)}
    params = {"cpu": on["cpu"].init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 101)),
                           dtype=torch.int32)
    patches = torch.as_tensor(RNG.normal(size=(2, cfg.n_patches,
                                               cfg.d_model)),
                              dtype=torch.float32)
    out, sels = {}, {}
    for d in ("cpu", dev):
        batch = {"tokens": toks[:, :100].to(d)}
        if cfg.family == "vlm":
            batch["patch_embs"] = patches.to(d)
        got = []
        moe.route_hook = lambda sel, keep: got.append(sel.cpu())
        try:
            before = fa.launches
            cache, logits = steps.build_prefill_step(
                on[d], 110 + cfg.n_patches)(params[d], batch)
            _, dec = steps.build_decode_step(on[d])(params[d], cache,
                                                    toks[:, 100:].to(d))
            launched = fa.launches - before
        finally:
            moe.route_hook = None
        assert launched == (cfg.n_layers if d == dev else 0)
        out[d], sels[d] = (logits, dec, cache["kv"]["k"]), got
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(sels[dev], sels["cpu"]))
    print(f"{arch} {serve_dtype}: {flips} tokens routed differently")
    for a, b in zip(out[dev], out["cpu"]):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2),
                                           ("zamba2-7b", 2), ("zamba2-7b", 5)])
def test_ssm_and_hybrid_prefill_and_decode_on_the_card_match_the_cpu(
        dev, arch, n_layers):
    """The reduced SSM and hybrid (zamba2 at 2 layers: one group, no tail;
    at 5: two groups and a tail of 1) in float32: prefill of 200 tokens
    (two SSD chunks, the second ragged) and a decode step on the card
    against the CPU, the logits and every cache leaf within 1e-4 of their
    largest value; the flash kernel launches 0 times for the SSM and once
    an application of the shared block for the hybrid."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              n_layers=n_layers)
    on = {d: steps.serving_model(cfg, serve_dtype="float32", device=d)
          for d in ("cpu", dev)}
    params = {"cpu": on["cpu"].init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 201)),
                           dtype=torch.int32)
    out, caches = {}, {}
    for d in ("cpu", dev):
        before = fa.launches
        cache, logits = steps.build_prefill_step(on[d], 210)(
            params[d], {"tokens": toks[:, :200].to(d)})
        launched = fa.launches - before
        pre = {k: v.clone() for k, v in zoo.flatten(cache)}
        cache, dec = steps.build_decode_step(on[d])(params[d], cache,
                                                    toks[:, 200:].to(d))
        want = (n_layers // cfg.shared_attn_every
                if cfg.family == "hybrid" else 0)
        assert launched == (want if d == dev else 0)
        out[d] = (logits, dec)
        caches[d] = {**{f"prefill.{k}": v for k, v in pre.items()},
                     **{f"decode.{k}": v for k, v in zoo.flatten(cache)}}
    for a, b in list(zip(out[dev], out["cpu"])) + [
            (caches[dev][k], caches["cpu"][k]) for k in caches["cpu"]]:
        if b.numel() == 0 or b.dtype == torch.int32:
            assert a.shape == b.shape and torch.equal(a.cpu(), b)
            continue
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("serve_dtype,tol", [("float32", 1e-4),
                                             ("bfloat16", 2e-2)])
def test_encdec_prefill_and_decode_on_the_card_match_the_cpu(
        dev, serve_dtype, tol):
    """Reduced whisper-medium (2 + 2 layers, 32 frames): prefill of 100
    tokens — the flash kernel once an encoder layer and twice a decoder
    layer (self and cross) on the card, never on the CPU — and a decode
    step, which launches none, against the CPU: the logits and every cache
    leaf (self K/V, cross K/V) within ``tol`` of their largest value."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(reduced_for_smoke(get_config("whisper-medium")),
                              dtype=serve_dtype)
    on = {d: steps.serving_model(cfg, serve_dtype=serve_dtype, device=d)
          for d in ("cpu", dev)}
    params = {"cpu": on["cpu"].init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab, (2, 101)),
                           dtype=torch.int32)
    frames = torch.as_tensor(RNG.normal(size=(2, cfg.enc_len, cfg.d_model)),
                             dtype=torch.float32)
    out, caches = {}, {}
    for d in ("cpu", dev):
        before = fa.launches
        cache, logits = steps.build_prefill_step(on[d], 110)(
            params[d], {"tokens": toks[:, :100].to(d),
                        "frames": frames.to(d)})
        launched = fa.launches - before
        cache, dec = steps.build_decode_step(on[d])(params[d], cache,
                                                    toks[:, 100:].to(d))
        assert fa.launches - before == launched
        assert launched == (cfg.n_enc_layers + 2 * cfg.n_layers
                            if d == dev else 0)
        out[d] = (logits, dec)
        caches[d] = dict(zoo.flatten(cache))
    for a, b in list(zip(out[dev], out["cpu"])) + [
            (caches[dev][k], caches["cpu"][k]) for k in caches["cpu"]]:
        if b.dtype == torch.int32:
            assert torch.equal(a.cpu(), b)
            continue
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_moe_init_peak_within_one_float32_layer_leaf(dev):
    """Two full-width qwen3-moe layers drawn in bf16 on the card: each
    stacked leaf is drawn a layer at a time, so the init's peak over the
    bf16 bytes stays within one layer's float32 expert leaf (E·d·f·4 =
    805 MB), not the whole stack's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer, zoo
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              param_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    blk = transformer._block_init(cfg, gen, 2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    nbytes = sum(t.numel() * t.element_size() for _, t in zoo.flatten(blk))
    leaf32 = cfg.n_experts * cfg.d_model * cfg.moe_ff * 4
    assert blk["moe"]["wi"].shape == (2, cfg.n_experts, cfg.d_model,
                                      cfg.moe_ff)
    assert blk["moe"]["wi"].dtype == torch.bfloat16
    assert nbytes < peak <= nbytes + leaf32 + (1 << 20), (peak, nbytes)
    w = blk["moe"]["wi"][1, 5].float()
    assert abs(float(w.std()) * cfg.n_experts ** 0.5 - 1) < 0.01


def _rel_to(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_on_the_card(dev, causal):
    """Path j1 at a small shape: blockwise attention (bk 128 over T = 300:
    padded keys) and its recompute backward against the grouped route under
    autograd on the card, and against the blockwise run on the CPU; f32,
    GQA g = 3, each of out, dq, dk, dv within 1e-4 of its largest entry."""
    from repro_torch.models import layers
    B, S, nh, nkv, hd = 2, 300, 6, 2, 64
    host = [torch.as_tensor(RNG.normal(size=s), dtype=torch.float32)
            for s in ((B, S, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd),
                      (B, S, nh * hd))]
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)

    def run(device, blockwise):
        q, k, v, dout = (t.to(device) for t in host)
        for t in (q, k, v):
            t.requires_grad_(True)
        p = pos.to(device)
        out = (layers.blockwise_attention(q, k, v, p, p, causal, 128)
               if blockwise else layers._grouped_attention(
                   q, k, v, layers.causal_mask(p, p) if causal else
                   torch.ones((1, 1, 1, 1, 1), dtype=torch.bool,
                              device=device)))
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    card, grouped, cpu = run(dev, True), run(dev, False), run("cpu", True)
    for a, b, c in zip(card, grouped, cpu):
        assert _rel_to(a, b) <= 1e-4 and _rel_to(a, c) <= 1e-4


def test_train_gradients_and_steps_on_the_card(dev):
    """Path j3 at a reduced llama3.2-3b (f32): gradients with remat on
    against off, grad_accum 2 against 1, the blockwise route against the
    grouped one (threshold lowered), and all of them against the CPU's,
    each leaf within 1e-4 of its largest entry; then three bf16 train
    steps on the card: finite, the loss falling, no kernel launched."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch import steps
    from repro_torch.models import layers, zoo
    from repro_torch.optim import adam
    base = reduced_for_smoke(get_config("llama3.2-3b"))
    params = {"cpu": zoo.build(base, device="cpu").init(0)}
    params[dev] = zoo.tree_map(lambda _, t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(RNG.integers(0, base.vocab, (2, 2, 96)),
                           dtype=torch.int32)
    batch = {"tokens": toks[0], "labels": toks[1]}

    def grads(device, threshold=2048, **over):
        model = zoo.build(dataclasses.replace(base, **over), device=device)
        saved, layers._BLOCKWISE_THRESHOLD = (layers._BLOCKWISE_THRESHOLD,
                                              threshold)
        try:
            _, _, g = steps.loss_and_grads(
                model, params[device],
                {k: v.to(device) for k, v in batch.items()})
        finally:
            layers._BLOCKWISE_THRESHOLD = saved
        out = {k: v.detach().clone() for k, v in zoo.flatten(g)}
        for _, p in zoo.flatten(params[device]):
            p.grad = None
        return out

    want = grads("cpu")
    for over in ({"remat": False}, {"remat": True}, {"grad_accum": 2},
                 {"threshold": 32}):
        got = grads(dev, **over)
        for name, g in want.items():
            assert _rel_to(got[name], g) <= 1e-4, (over, name)
    cfg = dataclasses.replace(base, dtype="bfloat16", remat=True,
                              grad_accum=2)
    model = zoo.build(cfg, device=dev)
    p = model.init(0)
    opt = adam.init(p)
    step = steps.build_train_step(model)
    before = fa.launches
    losses = []
    for _ in range(3):
        p, opt, met = step(p, opt, {k: v.to(dev) for k, v in batch.items()})
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert fa.launches == before


def test_stream_and_ooc_reach_every_kernel_per_partition_on_cuda(dev):
    """The stream and ooc modes on the card: summary, correlation, glm and
    kmeans from host RAM (``ooc``, staged synchronously) and a crossprod
    with XᵀY and a one-hot crossprod streamed from the device, in 8 KiB
    partitions with a ragged last one — each kernel launched once a
    partition, the results as whole mode's."""
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    n = 20001
    X = (RNG.normal(size=(n, 8)) * 2 + 1).astype(np.float32)
    beta = RNG.uniform(-1, 1, 8)
    y = (RNG.uniform(size=n) < 1 / (1 + np.exp(-(X - 1) @ beta))
         ).astype(np.float32)
    codes = [RNG.integers(0, lv, n) for lv in (7, 5, 11)]
    mods = (gram_mod, wg, faa, ka)
    res = {}
    with fm.conf(device="cuda", backend="cuda", prefetch=False,
                 io_partition_bytes=8192):
        for mode, host in (("whole", False), ("ooc", True)):
            before = [m.launches for m in mods]
            Xf, yf = fm.conv_R2FM(X, host=host), fm.conv_R2FM(y, host=host)
            fm.reset_exec_stats()
            res[mode] = (summary(Xf), correlation(Xf), glm(Xf, yf, max_iter=4),
                         kmeans(Xf, k=4, max_iter=3))
            st = fm.exec_stats()
            grew = [m.launches - b for m, b in zip(mods, before)]
            steps = st["partition_steps"] if host else st["passes"]
            assert min(grew) > 0 and sum(grew) >= steps
        Xd, Yd = fm.conv_R2FM(X), fm.conv_R2FM(y)
        Xs = fm.one_hot(*[fm.as_factor(c) for c in codes], host=False)
        grams = {}
        for mode in ("whole", "stream"):
            before = (gram_mod.launches, gram_mod.xty_launches,
                      spmm.gram_launches)
            fm.reset_exec_stats()
            grams[mode] = [fm.as_np(g) for g in fm.materialize(
                fm.crossprod(Xd), fm.crossprod(Xd, Yd), fm.crossprod(Xs),
                mode=mode)]
            steps = fm.exec_stats()["partition_steps"]
            after = (gram_mod.launches, gram_mod.xty_launches,
                     spmm.gram_launches)
            assert all(a - b == steps for a, b in zip(after, before))
            assert (steps > 1) == (mode == "stream")
    (s, c, g, k), (s2, c2, g2, k2) = res["ooc"], res["whole"]
    np.testing.assert_allclose(s.mean, s2.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.col_min, s2.col_min)
    np.testing.assert_allclose(c, c2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.beta, g2.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(k.wss, k2.wss, rtol=1e-3)
    for a, b in zip(grams["stream"], grams["whole"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# The partition prefetcher on the card: pinned ring + side stream
# ---------------------------------------------------------------------------

def _host_x(n, p, seed=0):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)


def _drain(pf, sleep_cycles=0, acc_dtype=torch.float64):
    """Consume a prefetcher as a step would: optionally slowed by a sleep
    on the compute stream, then a column sum and a Gram of each block in
    float64 — deterministic, so two runs agree bit for bit."""
    out = []
    for start, stop, blocks in pf:
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        blk = blocks[0]
        x = blk.to(acc_dtype)
        out.append((start, stop, x.sum(0), x.T @ x))
    return out


def _sync_parts(store, rows, n, dev):
    from repro_torch.storage.prefetch import stage_block
    return [(s, min(s + rows, n), {0: stage_block(store, s, min(s + rows, n),
                                                  device=dev)})
            for s in range(0, n, rows)]


@pytest.mark.parametrize("depth", [1, 8])
def test_prefetcher_slowed_consumer_equals_synchronous(dev, depth):
    """Invariants 2 and 3: a consumer slowed on the compute stream at
    depth 1 and 8 sees each partition's data exactly — bit for bit as the
    synchronous staging — and the compute thread never synchronizes while
    it consumes."""
    from repro_torch.core.matrix import DenseStore
    from repro_torch.storage import PartitionPrefetcher
    A = _host_x(40_000, 16)
    store = DenseStore(A)
    want = _drain(_sync_parts(store, 512, 40_000, dev))
    calls = {"n": 0}
    main = threading.get_ident()
    targets = [(torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
               (torch.cuda.Event, "synchronize")]
    reals = [getattr(o, a) for o, a in targets]

    def counting(real):
        def wrapped(*a, **k):
            if threading.get_ident() == main:
                calls["n"] += 1
            return real(*a, **k)
        return wrapped

    pf = PartitionPrefetcher([(0, store)], 512, 40_000, depth=depth,
                             device=dev)
    for (o, a), real in zip(targets, reals):
        setattr(o, a, counting(real))
    try:
        got = _drain(pf, sleep_cycles=200_000)
    finally:
        for (o, a), real in zip(targets, reals):
            setattr(o, a, real)
        pf.close()
    assert calls["n"] == 0, "the consumer waited on the host"
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g[2], w[2]) and torch.equal(g[3], w[3])


def test_prefetcher_pinned_slot_not_refilled_early(dev):
    """Invariant 1: every fill of a pinned slot finds each earlier copy out
    of it complete; the copies run on the side stream, never the compute
    stream (Invariant 4's explicit device and stream too)."""
    from repro_torch.core.matrix import DenseStore
    from repro_torch.storage import PartitionPrefetcher, prefetch
    A = _host_x(1 << 16, 32)
    ends: dict = {}
    early, streams = [], set()
    real_fill, real_copy = prefetch._PinnedSlot.fill, prefetch._PinnedSlot.copy

    def fill(self, key, arr):
        early.extend(e for e in ends.get(id(self), ()) if not e.query())
        return real_fill(self, key, arr)

    def copy(self, host, device):
        streams.add((torch.cuda.current_device(),
                     torch.cuda.current_stream().cuda_stream))
        out = real_copy(self, host, device)
        ends.setdefault(id(self), []).append(self.copies[-1][1])
        return out

    prefetch._PinnedSlot.fill, prefetch._PinnedSlot.copy = fill, copy
    try:
        pf = PartitionPrefetcher([(0, DenseStore(A))], 1024, A.shape[0],
                                 depth=8, device=dev)
        got = _drain(pf, sleep_cycles=50_000)
        side = pf._side.cuda_stream
        compute = pf._compute.cuda_stream
        pf.close()
    finally:
        prefetch._PinnedSlot.fill, prefetch._PinnedSlot.copy = \
            real_fill, real_copy
    assert not early, f"{len(early)} fills found a copy still running"
    assert streams == {(dev.index or 0, side)} and side != compute
    want = _drain(_sync_parts(DenseStore(A), 1024, A.shape[0], dev))
    assert all(torch.equal(g[3], w[3]) for g, w in zip(got, want))


def test_prefetcher_resident_final_partition_across_passes(dev):
    """Invariant 3 across passes: inside an iteration_scope the final
    partition staged on the side stream stays resident and is served to
    the next materialize (a reuse hit), the compute stream slowed between
    — the results equal the synchronous runs' bit for bit, and every
    staged block was recorded onto the compute stream."""
    from repro_torch.core import fm
    A = _host_x(30_001, 8, seed=3)
    recorded = {"n": 0}
    real = torch.Tensor.record_stream

    def record(self, stream):
        recorded["n"] += 1
        return real(self, stream)

    out = {}
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 16):
        X = fm.conv_R2FM(A, host=True)
        for prefetch in (False, True):
            torch.Tensor.record_stream = record
            try:
                fm.reset_exec_stats()
                with fm.inspect_iterations():
                    res = []
                    for i in range(3):
                        torch.cuda._sleep(2_000_000)
                        (g,) = fm.materialize(fm.crossprod(X * float(i + 1)),
                                              prefetch=prefetch)
                        res.append(fm.as_np(g))
                st = fm.exec_stats()
            finally:
                torch.Tensor.record_stream = real
            out[prefetch] = (res, st["prefetch_reuse_hits"], recorded["n"])
            recorded["n"] = 0
    (sync, sync_hits, _), (pre, pre_hits, n_rec) = out[False], out[True]
    assert pre_hits == sync_hits == 2
    assert n_rec > 0
    for a, b in zip(pre, sync):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_fault_midstream_leaks_nothing(dev):
    """Invariant 5: a staging fault mid-stream on the card reaches
    materialize as PrefetchError with the rows and the source, registers
    nothing, and leaves no worker thread, queued partition, resident or
    pinned slot; an abandoned prefetcher's close() synchronizes the side
    stream and drops its ring."""
    import time
    from helpers_cache import StagingFault
    from repro_torch import storage
    from repro_torch.core import dag, fm, materialize as mz
    from repro_torch.core.matrix import DenseStore, FMMatrix
    A = _host_x(20_000, 8, seed=4)

    class Flaky(DenseStore):
        reads = 0

        def block(self, start, stop):
            Flaky.reads += 1
            if Flaky.reads > 5:
                raise StagingFault("injected fault")
            return super().block(start, stop)

    X = FMMatrix(A.shape, A.dtype, store=Flaky(A), name="flaky_card")
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 14):
        Z = fm.scale(fm.FM(X))
        nodes = dag.toposort([Z.m.node])
        with mz.iteration_scope():
            with pytest.raises(storage.PrefetchError,
                               match=r"rows \[\d+, \d+\) of source "
                                     r"'flaky_card'"):
                fm.materialize(Z)
            assert mz._tls_residents() is None
    assert all(getattr(n, "cached_store", None) is None for n in nodes)
    deadline = time.time() + 10
    while time.time() < deadline and storage.live_prefetchers():
        time.sleep(0.02)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []
    assert not any(t.name == "fm-prefetch" for t in threading.enumerate())
    pf = storage.PartitionPrefetcher([(0, DenseStore(A))], 256, A.shape[0],
                                     depth=2, device=dev)
    it = iter(pf)
    next(it)
    pf.close()
    assert not pf.alive and pf.queued == 0 and pf._slots == []
    assert pf._side.query()


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetcher_staged_memory_bounded(dev, depth):
    """Invariant 6: with the compute stream far behind the host (a long
    sleep a partition), staged device memory stays within (depth + 2)
    partitions however many partitions the stream has: the live tensors,
    and the caching allocator's segments of the side stream, freed blocks
    held back for the compute stream included (the consumer's own
    reduction workspace lives on the compute stream and is not counted)."""
    from repro_torch.core.matrix import DenseStore
    from repro_torch.storage import PartitionPrefetcher
    rows, p = 1 << 14, 192
    # 12 MiB a partition: above the caching allocator's 10 MiB class, so a
    # segment is one block and the side stream's segments count partitions
    part = rows * p * 4
    A = _host_x(rows * 40, p, seed=5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    acc = torch.zeros(p, device=dev)
    with PartitionPrefetcher([(0, DenseStore(A))], rows, A.shape[0],
                             depth=depth, device=dev) as pf:
        for _, _, blocks in pf:
            torch.cuda._sleep(5_000_000)
            # the column sum in two stages: a one-stage sum(0) of a
            # 16,384 × 192 partition allocates a 24 MiB reduction buffer on
            # the compute stream, two partitions of memory that the peak
            # would count beside the staged ones
            acc += blocks[0].view(-1, 128, p).sum(1).sum(0)
            del blocks
        side = pf._side.cuda_stream
        # segments are kept until empty_cache: the side stream's high mark
        held = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s["stream"] == side)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= (depth + 2) * part + (1 << 20), (peak, part)
    assert 0 < held <= (depth + 2) * part, (held, part)
    np.testing.assert_allclose(acc.cpu().numpy(), A.sum(0), rtol=1e-3,
                               atol=1e-2)


def test_host_ell_slab_against_the_device_slab(dev):
    """fm.one_hot's host slab streamed out of core through the prefetcher:
    crossprod equal to the device slab's whole-mode Gram bit for bit, one
    spmm_gram launch a partition; the logistic fit's log-likelihoods within
    1e-4 of the device slab's, spmm_xty and spmm_wgram launched."""
    from repro_torch.algorithms import glm
    from repro_torch.core import fm
    rng = np.random.default_rng(6)
    n, levels = 50_001, (13, 7, 5)
    codes = [rng.integers(0, lv, n) for lv in levels]
    yn = (rng.uniform(size=n) < 0.3).astype(np.float32).reshape(-1, 1)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 16):
        fs = [fm.as_factor(c, lv) for c, lv in zip(codes, levels)]
        Xh, Xd = fm.one_hot(*fs), fm.one_hot(*fs, host=False)
        assert Xh.m.on_host and not Xd.m.on_host
        (gd,) = fm.materialize(fm.crossprod(Xd), mode="whole")
        before = spmm.gram_launches
        fm.reset_exec_stats()
        (gh,) = fm.materialize(fm.crossprod(Xh), mode="ooc")
        steps = fm.exec_stats()["partition_steps"]
        assert steps > 1 and spmm.gram_launches - before == steps
        np.testing.assert_array_equal(fm.as_np(gh), fm.as_np(gd))
        y = fm.conv_R2FM(yn)
        before = (spmm.xty_launches, spmm.wgram_launches)
        rh = glm(Xh, y, "logistic", ridge=1e-3, max_iter=3, mode="ooc")
        assert spmm.xty_launches > before[0]
        assert spmm.wgram_launches > before[1]
        rd = glm(Xd, y, "logistic", ridge=1e-3, max_iter=3, mode="stream")
    np.testing.assert_allclose(rh.loglik_trace, rd.loglik_trace, rtol=1e-4)


# ---------------------------------------------------------------------------
# The disk tier on the card: .fmat files through the pinned ring
# ---------------------------------------------------------------------------

@pytest.fixture
def disk_dir(dev, tmp_path, monkeypatch):
    from repro_torch import storage
    monkeypatch.setitem(storage.registry._CONF, "data_dir", None)
    storage.set_conf(data_dir=str(tmp_path / "fmdata"))
    return tmp_path / "fmdata"


@pytest.mark.parametrize("direct_io", [False, True])
def test_mmap_source_through_the_pinned_ring(disk_dir, direct_io):
    """An MmapStore source ('row' and 'col' files, f32 and f64) streamed
    ooc through the pinned ring and side stream — warm, and with direct_io
    (pages dropped after each read) — equals the host-tier run bit for bit
    with the same launches, steps and bytes read; a float64 file reaches
    the card as float32."""
    from repro_torch.core import fm
    from repro_torch.observability import metrics
    A = _host_x(40_001, 8, seed=7)
    for dtype, layout in ((np.float32, "row"), (np.float32, "col"),
                          (np.float64, "row")):
        a = A.astype(dtype)
        with fm.conf(device="cuda", backend="cuda",
                     io_partition_bytes=1 << 16):
            Xd = fm.load_dense_matrix(a, f"ring_{layout}_{a.dtype.name}",
                                      layout=layout)
            Xh = fm.conv_R2FM(a.astype(np.float32), host=True)
            runs = []
            for X, dio in ((Xh, False), (Xd, direct_io)):
                with fm.conf(direct_io=dio):
                    fm.reset_exec_stats()
                    g0 = gram_mod.launches
                    read0 = metrics.root_counter("stage_bytes_read")
                    G, s = fm.materialize(fm.crossprod(X), fm.colSums(X),
                                          mode="ooc")
                    torch.cuda.synchronize()
                    st = fm.exec_stats()
                    runs.append((fm.as_np(G), fm.as_np(s),
                                 gram_mod.launches - g0,
                                 st["partition_steps"],
                                 metrics.root_counter("stage_bytes_read")
                                 - read0))
        (gh, sh, lh, ph, bh), (gd, sd, ld, pd, bd) = runs
        np.testing.assert_array_equal(gd, gh)
        np.testing.assert_array_equal(sd, sh)
        assert ld == lh == pd == ph > 1
        assert bd == a.nbytes and bh == A.nbytes


def test_spill_from_cuda_partitions_equals_whole_mode(disk_dir):
    """save='disk' written from CUDA partitions (copied to host after the
    step, a partition at a time): the spill file's body equals whole
    mode's output byte for byte; a bf16 output is stored as float32."""
    from repro_torch.core import fm
    A = _host_x(30_000, 6, seed=8)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A)
        bodies = []
        for mode in ("stream", "whole"):
            Z = fm.sqrt(fm.abs_(X)) * 3.0 - 1.0
            fm.persist(Z, tier="disk")
            fm.reset_exec_stats()
            (Zm,) = fm.materialize(Z, mode=mode)
            assert Zm.m.on_disk
            steps = fm.exec_stats()["partition_steps"]
            assert (steps > 1) == (mode == "stream")
            bodies.append(Zm.m.store.path.read_bytes()[4096:])
        assert bodies[0] == bodies[1]
        B = fm.conv_R2FM(torch.from_numpy(A).to(torch.bfloat16))
        Zb = B * 2.0
        fm.persist(Zb, tier="disk")
        (Zbm,) = fm.materialize(Zb, mode="stream")
    assert Zbm.m.store.header.dtype == np.float32
    want = (torch.from_numpy(A).to(torch.bfloat16) * 2.0).float().numpy()
    np.testing.assert_array_equal(np.asarray(Zbm.m.logical_data()), want)


def test_csr_file_crossprod_equals_the_device_slab(disk_dir):
    """A CsrMmapStore streamed ooc through the prefetcher: crossprod equal
    to the device slab's whole-mode Gram bit for bit, one spmm_gram launch
    a partition."""
    from repro_torch.core import fm
    rng = np.random.default_rng(9)
    n, levels = 60_001, (13, 7, 5)
    codes = [rng.integers(0, lv, n) for lv in levels]
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 16):
        fs = [fm.as_factor(c, lv) for c, lv in zip(codes, levels)]
        Xdev = fm.one_hot(*fs, host=False)
        Xc = fm.persist(Xdev, tier="disk", name="csr_card")
        assert Xc.m.on_disk and Xc.m.is_sparse
        (gd,) = fm.materialize(fm.crossprod(Xdev), mode="whole")
        before = spmm.gram_launches
        fm.reset_exec_stats()
        (gc,) = fm.materialize(fm.crossprod(Xc), mode="ooc")
        steps = fm.exec_stats()["partition_steps"]
    assert steps > 1 and spmm.gram_launches - before == steps
    np.testing.assert_array_equal(fm.as_np(gc), fm.as_np(gd))


def test_disk_read_fault_leaks_nothing(disk_dir):
    """A disk read that fails mid-stream raises PrefetchError naming the
    rows and the file, and the leak audit (live_prefetchers,
    staged_leaks) is empty afterwards."""
    import time
    from repro_torch import storage
    from repro_torch.core import fm
    from repro_torch.core.matrix import FMMatrix
    A = _host_x(20_000, 8, seed=10)
    path = disk_dir / "fault.fmat"
    storage.save_matrix(path, A)

    class Failing(storage.MmapStore):
        reads = 0

        def block(self, start, stop):
            Failing.reads += 1
            if Failing.reads > 4:
                raise OSError(f"read error in {self.path}")
            return super().block(start, stop)

    X = FMMatrix(A.shape, A.dtype,
                 store=Failing(path, storage.read_header(path)))
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 14):
        with pytest.raises(storage.PrefetchError,
                           match=r"rows \[\d+, \d+\) of source '.*fault\."
                                 r"fmat'"):
            fm.materialize(fm.crossprod(fm.FM(X)), mode="ooc")
    deadline = time.time() + 10
    while time.time() < deadline and storage.live_prefetchers():
        time.sleep(0.02)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


# ---------------------------------------------------------------------------
# fm.batch on the card: k members' kernels on each staged partition
# ---------------------------------------------------------------------------

def _batch_requests(fm, X, Y):
    """Three members over {X, y}: colMeans (fused_apply_agg), crossprod
    (gram) and XᵀY (xty) — the first two ride the third's stream."""
    return [fm.colMeans(X), fm.crossprod(X), fm.crossprod(X, Y)]


def _batch_kernels():
    return (faa.launches, gram_mod.launches, gram_mod.xty_launches)


@pytest.mark.parametrize("depth", [1, 4])
def test_batch_group_from_host_ram_through_the_prefetcher(dev, depth,
                                                          monkeypatch):
    """A 3-member group from host RAM, staged by the prefetcher at depth 1
    and 4: one stream, three passes, each member's kernel launched once a
    partition of the group, every result within 1e-6 of its serial run."""
    from repro_torch import storage
    from repro_torch.core import fm
    n = 50_001
    A = _host_x(n, 8, seed=11)
    y = _host_x(n, 1, seed=12)
    monkeypatch.setattr(storage, "negotiate_depth", lambda *a, **k: depth)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X, Y = fm.conv_R2FM(A, host=True), fm.conv_R2FM(y, host=True)
        serial = [fm.as_np(fm.materialize(r, mode="ooc")[0])
                  for r in _batch_requests(fm, X, Y)]
        fm.reset_exec_stats()
        before = _batch_kernels()
        with fm.trace():
            got = fm.batch(*_batch_requests(fm, X, Y), mode="ooc",
                           prefetch=True)
            rows = [e["args"]["rows"] for e in fm.trace_events()
                    if e["name"] == "stream"]
        grew = [a - b for a, b in zip(_batch_kernels(), before)]
        st = fm.exec_stats()
    assert st["streams"] == 1 and st["passes"] == 3
    assert st["pass_bytes_in"] == (A.nbytes + y.nbytes,)
    parts = -(-n // rows[0])
    assert parts > 4 and st["partition_steps"] == 3 * parts
    assert grew == [parts, parts, parts], (grew, parts)
    for g, s in zip(got, serial):
        np.testing.assert_allclose(fm.as_np(g), s, rtol=1e-6, atol=1e-6)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


def test_batch_partition_not_restaged_under_a_member(dev, monkeypatch):
    """The prefetcher's done event is recorded after the last member's step
    on a partition: with every member's step delayed on the compute stream
    and depth 1, a 3-member group's results equal the synchronous run's
    bit for bit (no partition was re-staged, and no pinned slot refilled,
    while a member still read it)."""
    from repro_torch import storage
    from repro_torch.core import fm, materialize
    n = 40_000
    A = _host_x(n, 16, seed=13)
    y = _host_x(n, 1, seed=14)
    step = materialize._member_step

    def slowed(*args, **kw):
        torch.cuda._sleep(1_000_000)
        return step(*args, **kw)

    monkeypatch.setattr(storage, "negotiate_depth", lambda *a, **k: 1)
    out = {}
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X, Y = fm.conv_R2FM(A, host=True), fm.conv_R2FM(y, host=True)
        for prefetch in (False, True):
            monkeypatch.setattr(materialize, "_member_step", slowed)
            got = fm.batch(*_batch_requests(fm, X, Y), mode="ooc",
                           prefetch=prefetch)
            monkeypatch.setattr(materialize, "_member_step", step)
            out[prefetch] = [fm.as_np(g) for g in got]
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


# ---------------------------------------------------------------------------
# fm.serve on the card: kernels launched from the Engine's worker threads
# ---------------------------------------------------------------------------

def test_launch_counters_exact_under_threads(dev):
    """8 threads × 50 gram calls count exactly 400 launches: the wrappers'
    counters are guarded by one lock (a lost ``+=`` would show here with
    the interpreter switching threads every few microseconds)."""
    import sys
    x = _x(4096, 8, torch.float32, dev)
    gram_mod.gram(x)
    torch.cuda.synchronize()
    errors, barrier = [], threading.Barrier(8)

    def worker():
        try:
            barrier.wait(timeout=30)
            for _ in range(50):
                gram_mod.gram(x)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = gram_mod.launches
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads), errors
    torch.cuda.synchronize()
    assert gram_mod.launches - before == 400


def _serve_requests(fm, X, Y):
    return [fm.colMeans(X), fm.crossprod(X), fm.crossprod(X, Y)]


def test_engine_window_equals_batch_bit_for_bit(dev):
    """Three requests from three threads in one Engine window run as one
    group on a pool thread: one stream, each member's kernel once a
    partition, every result equal to the same requests' ``fm.batch`` bit
    for bit (the same group at the same rows)."""
    from repro_torch import storage
    from repro_torch.core import fm
    n = 50_001
    A, y = _host_x(n, 8, seed=21), _host_x(n, 1, seed=22)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X, Y = fm.conv_R2FM(A, host=True), fm.conv_R2FM(y, host=True)
        batched = [fm.as_np(r) for r in
                   fm.batch(*_serve_requests(fm, X, Y), mode="ooc")]
        reqs = _serve_requests(fm, X, Y)
        fm.reset_exec_stats()
        before = _batch_kernels()
        handles, barrier = [None] * 3, threading.Barrier(3)
        with fm.serve(window_ms=60_000, max_window_requests=3, mode="ooc",
                      midstream_admission=False) as eng:
            def submit(i):
                barrier.wait(timeout=30)
                handles[i] = eng.submit(reqs[i])

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            served = [fm.as_np(h.result(timeout=120)) for h in handles]
        grew = [a - b for a, b in zip(_batch_kernels(), before)]
        st = fm.exec_stats()
    assert st["streams"] == 1 and st["passes"] == 3
    parts = st["partition_steps"] // 3
    assert parts > 4 and grew == [parts, parts, parts], (grew, parts)
    for s, b in zip(served, batched):
        np.testing.assert_array_equal(s, b)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_midstream_join_on_the_card(dev, prefetch):
    """A late colMeans joins a live colSums sweep at a partition boundary
    (the host store holds the sweep at its second read until the late
    request is parked): one admit, one stream, the catch-up restaging
    exactly the prefix the late member missed (its ``catch_up`` span's
    rows), both results within float32 rounding of float64."""
    from repro_torch import storage
    from repro_torch.core import fm
    from repro_torch.core.matrix import DenseStore, FMMatrix
    from repro_torch.observability import metrics
    n, p = 80_000, 8
    A = _host_x(n, p, seed=23)
    started, release = threading.Event(), threading.Event()

    class Paced(DenseStore):
        reads = 0

        def block(self, start, stop):
            self.reads += 1
            if self.reads == 2:
                started.set()
                release.wait(timeout=30)
            return super().block(start, stop)

    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = FMMatrix(A.shape, A.dtype, store=Paced(A), name="paced")
        fm.reset_exec_stats()
        with fm.trace(), fm.serve(window_ms=1, prefetch=prefetch) as eng:
            h1 = eng.submit(fm.colSums(X))
            assert started.wait(timeout=30)
            h2 = eng.submit(fm.colMeans(X))
            release.set()
            sums, means = (fm.as_np(h.result(timeout=120)) for h in (h1, h2))
            upto = [e["args"]["upto"] for e in fm.trace_events()
                    if e["name"] == "catch_up"]
            rows = [e["args"]["rows"] for e in fm.trace_events()
                    if e["name"] == "stream"]
        st = fm.exec_stats()
        streamed = metrics.root_counter("bytes_streamed")
    assert st["midstream_admits"] == 1 and st["streams"] == 1 \
        and st["passes"] == 2
    missed = upto[0] if upto else 0
    assert streamed - A.nbytes == missed * p * 4
    if not prefetch:  # parked while the sweep waited: joins at partition 1
        assert missed == rows[0]
    a64 = A.astype(np.float64)
    np.testing.assert_allclose(sums.ravel(), a64.sum(0), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(means.ravel(), a64.mean(0), rtol=1e-4,
                               atol=1e-6)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


def test_engine_two_groups_exact_launch_counts(dev):
    """One window over two disjoint sources forms two groups, run at once
    on two pool threads: two streams, each kernel launched exactly once a
    partition of each group, every result equal bit for bit to its group's
    ``fm.batch``."""
    from repro_torch.core import fm
    n1, n2 = 40_000, 30_001
    A1, A2 = _host_x(n1, 8, seed=24), _host_x(n2, 8, seed=25)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X1, X2 = fm.conv_R2FM(A1, host=True), fm.conv_R2FM(A2, host=True)
        want = [fm.as_np(r) for X in (X1, X2)
                for r in fm.batch(fm.colMeans(X), fm.crossprod(X),
                                  mode="ooc")]
        parts = []
        for X in (X1, X2):
            fm.reset_exec_stats()
            fm.batch(fm.colMeans(X), fm.crossprod(X), mode="ooc")
            parts.append(fm.exec_stats()["partition_steps"] // 2)
        reqs = [fm.colMeans(X1), fm.crossprod(X1), fm.colMeans(X2),
                fm.crossprod(X2)]
        fm.reset_exec_stats()
        torch.cuda.synchronize()
        g0, f0 = gram_mod.launches, faa.launches
        with fm.serve(window_ms=60_000, max_window_requests=4, mode="ooc",
                      max_concurrent_streams=2,
                      midstream_admission=False) as eng:
            handles = [eng.submit(r) for r in reqs]
            got = [fm.as_np(h.result(timeout=120)) for h in handles]
        st = fm.exec_stats()
    assert st["streams"] == 2 and st["passes"] == 4
    assert gram_mod.launches - g0 == sum(parts)
    assert faa.launches - f0 == sum(parts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_result_read_on_a_fresh_stream_sees_finished_values(dev,
                                                            monkeypatch):
    """A future resolves only after its group's device work has run: with
    every step delayed on the compute stream, a thread whose current
    stream is a fresh ``torch.cuda.Stream`` copies the result on that
    stream, with no synchronization of its own, and reads the finished
    values."""
    from repro_torch.core import fm, materialize
    n = 40_000
    A = _host_x(n, 8, seed=26)
    step = materialize._member_step

    def slowed(*args, **kw):
        torch.cuda._sleep(2_000_000)
        return step(*args, **kw)

    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A, host=True)
        (want,) = fm.materialize(fm.crossprod(X), mode="ooc")
        want = fm.as_np(want)
        monkeypatch.setattr(materialize, "_member_step", slowed)
        out, errors = {}, []
        with fm.serve(window_ms=1) as eng:
            h = eng.submit(fm.crossprod(X))

            def reader():
                try:
                    side = torch.cuda.Stream()
                    with torch.cuda.stream(side):
                        g = fm._fm(h.result(timeout=120)).logical_data()
                        copy = torch.empty_like(g)
                        copy.copy_(g, non_blocking=True)
                    side.synchronize()
                    out["g"] = copy.cpu().numpy()
                except Exception as exc:  # noqa: BLE001 - surfaced below
                    errors.append(exc)

            t = threading.Thread(target=reader)
            t.start()
            t.join(timeout=180)
    assert not errors and not t.is_alive(), errors
    np.testing.assert_array_equal(out["g"], want)


# ---------------------------------------------------------------------------
# Sharded execution over [cuda:0] × k
# ---------------------------------------------------------------------------

def _card_mesh(k):
    from repro_torch.launch.mesh import Mesh
    return Mesh([torch.device("cuda", 0)] * k, ("data",))


def _mesh_calls(fm, X):
    return [fm.crossprod(X), fm.colMeans(X)]


@pytest.mark.parametrize("mode", ["stream", "ooc"])
def test_mesh_one_shard_equals_unsharded_bit_for_bit(dev, mode):
    """A mesh of one shard runs the unsharded schedule: the same results
    bit for bit, one shard, no merge, the same launches."""
    from repro_torch.core import fm
    A = _host_x(60_001, 8, seed=31)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A, host=(mode == "ooc"))
        want = [fm.as_np(g) for g in fm.materialize(*_mesh_calls(fm, X),
                                                     mode=mode)]
        g0 = gram_mod.launches
        fm.reset_exec_stats()
        got = [fm.as_np(g) for g in fm.materialize(
            *_mesh_calls(fm, X), mode=mode, mesh=_card_mesh(1))]
        st = fm.exec_stats()
    assert (st["shards"], st["shard_merges"]) == (1, 0)
    assert gram_mod.launches - g0 == st["partition_steps"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["stream", "ooc"])
def test_mesh_shards_within_tolerance_and_deterministic(dev, k, mode):
    """k shards on one card: results within float32 merge-order tolerance
    of the unsharded run and bit for bit from run to run (the merge order
    is fixed), with the reference's accounting: k shards, k − 1 merges,
    the partition steps and gram launches of the unsharded run."""
    from repro_torch import storage
    from repro_torch.core import fm
    A = _host_x(60_001, 8, seed=32)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A, host=(mode == "ooc"))
        fm.reset_exec_stats()
        want = [fm.as_np(g) for g in fm.materialize(*_mesh_calls(fm, X),
                                                     mode=mode)]
        steps = fm.exec_stats()["partition_steps"]
        runs = []
        for _ in range(2):
            fm.reset_exec_stats()
            g0 = gram_mod.launches
            runs.append([fm.as_np(g) for g in fm.materialize(
                *_mesh_calls(fm, X), mode=mode, mesh=_card_mesh(k))])
            st = fm.exec_stats()
            assert (st["shards"], st["shard_merges"]) == (k, k - 1)
            assert st["partition_steps"] == steps
            assert gram_mod.launches - g0 == steps
            assert sum(st["shard_bytes_in"]) == A.nbytes
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(runs[0], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []


def test_mesh_shards_run_on_their_own_streams(dev, monkeypatch):
    """Each shard's steps run on a CUDA stream of its own, not the caller's:
    with the last shard's steps delayed on its stream, the merged result
    equals the undelayed sharded run bit for bit (the merge waits for
    every shard's stream)."""
    from repro_torch.core import fm, materialize
    A = _host_x(60_001, 8, seed=33)
    step = materialize._member_step
    streams, lock = set(), threading.Lock()

    def slowed(member, blocks, key_map, start, stop, **kw):
        with lock:
            streams.add(torch.cuda.current_stream().cuda_stream)
        if start >= 40_000:
            torch.cuda._sleep(5_000_000)
        return step(member, blocks, key_map, start, stop, **kw)

    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A)
        mesh = _card_mesh(2)
        want = [fm.as_np(g) for g in fm.materialize(
            *_mesh_calls(fm, X), mode="stream", mesh=mesh)]
        monkeypatch.setattr(materialize, "_member_step", slowed)
        caller = torch.cuda.current_stream().cuda_stream
        got = [fm.as_np(g) for g in fm.materialize(
            *_mesh_calls(fm, X), mode="stream", mesh=mesh)]
    assert len(streams) == 2 and caller not in streams, (streams, caller)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mesh_shard_fault_leaks_nothing(dev):
    """A staging fault in one shard fails the sweep: nothing registers, and
    no prefetcher, staged partition or shard thread outlives the call."""
    import time
    from repro_torch import storage
    from repro_torch.core import fm
    from repro_torch.core.matrix import DenseStore, FMMatrix

    class FlakyStore(DenseStore):
        def __init__(self, data):
            super().__init__(np.asarray(data))
            self.reads, self.lock = 0, threading.Lock()

        def block(self, start, stop):
            with self.lock:
                self.reads += 1
                n = self.reads
            if n > 3:
                raise RuntimeError("injected shard staging failure")
            return super().block(start, stop)

    A = _host_x(60_001, 8, seed=34)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        Xf = FMMatrix(A.shape, A.dtype, store=FlakyStore(A), name="flaky")
        G = fm.crossprod(fm.FM(Xf) * 2.0)
        with pytest.raises(Exception, match="injected shard staging"):
            fm.materialize(G, mode="ooc", prefetch=True, mesh=_card_mesh(2))
    assert G.m.is_virtual and getattr(G.m, "cached_store", None) is None
    deadline = time.time() + 10
    while time.time() < deadline and storage.live_prefetchers():
        time.sleep(0.05)
    assert storage.live_prefetchers() == [] and storage.staged_leaks() == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith("fm-shard")]


def test_engine_under_mesh_opens_no_gate(dev):
    """``Engine(mesh=)`` shards each group over ``[cuda:0] × 2`` and admits
    no member mid-stream; results equal the sharded ``fm.batch``."""
    from repro_torch.core import fm
    A = _host_x(60_001, 8, seed=35)
    with fm.conf(device="cuda", backend="cuda", io_partition_bytes=1 << 15):
        X = fm.conv_R2FM(A, host=True)
        mesh = _card_mesh(2)
        want = [fm.as_np(g) for g in fm.batch(*_mesh_calls(fm, X),
                                              mode="ooc", mesh=mesh)]
        fm.reset_exec_stats()
        with fm.serve(window_ms=200, max_window_requests=2, mode="ooc",
                      mesh=mesh) as eng:
            handles = [eng.submit(r) for r in _mesh_calls(fm, X)]
            got = [fm.as_np(h.result(timeout=120)) for h in handles]
            with eng._gates_lock:
                assert eng._gates == []
        st = fm.exec_stats()
    assert st["shards"] == 2 and st["midstream_admits"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
