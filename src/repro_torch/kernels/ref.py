"""Plain PyTorch versions of the ported kernels: the correctness contract.

The wrappers use these for tensors on the CPU (the CPU tests), and
``chip_smoke.py`` holds each kernel against them on the card.  They repeat
the reference oracles of repro/kernels/ref.py in PyTorch, except that a few
are shaped to stay within memory at the main path's size:
``kmeans_assign_ref`` forms distances by the kernel's expansion
(‖x‖² − 2x·c + ‖c‖², repro/kernels/kmeans_assign.py:48-52), since the direct
(n, k, p) difference tensor would not fit, and the SpMM versions densify the
ELL slab a chunk of rows at a time (``SPMM_CHUNK_ELEMS``) where the reference
densifies it whole — a dense copy of the Criteo slab is 305 GB.  The SpMM
versions take ``dtype`` (float64 for the checks on the card).
"""
from __future__ import annotations

import torch

from ..core import vudf as vudf_mod

#: fused_summary's chain spec: (sum, sum-of-squares, min, max, L1, nnz).
SUMMARY_CHAINS = (((), "sum"), (("sq",), "sum"), ((), "min"), ((), "max"),
                  (("abs",), "sum"), ((), "count_nonzero"))


def gram_ref(x):
    x = x.to(torch.float32)
    return x.T @ x


def xty_ref(x, y):
    return x.to(torch.float32).T @ y.to(torch.float32)


def wgram_ref(x, w):
    xf = x.to(torch.float32)
    wf = w.to(torch.float32).reshape(-1, 1)
    return (xf * wf).T @ xf


def fused_apply_agg_ref(x, chains):
    """``chains``: normalized ((unaries, agg, acc_dtype), ...).  Each chain
    evaluates its unaries on x (cast to f32 for a float accumulator, in the
    source type for an int one) and aggregates per column, as the
    reference's chain kernel body does."""
    outs = []
    for unaries, agg, acc in chains:
        at = torch.float32 if acc == "float32" else torch.int32
        v = x.to(torch.float32) if at == torch.float32 else x
        for u in unaries:
            v = vudf_mod.unary(u).fn(v)
        if agg == "sum":
            out = v.to(at).sum(0, dtype=at)
        elif agg == "count":
            out = torch.full((x.shape[1],), x.shape[0], dtype=at,
                             device=x.device)
        elif agg == "count_nonzero":
            out = (v != 0).to(at).sum(0, dtype=at)
        elif agg == "min":
            out = v.to(at).amin(0) if x.shape[0] else torch.full(
                (x.shape[1],), _extreme(at, True), dtype=at, device=x.device)
        else:
            out = v.to(at).amax(0) if x.shape[0] else torch.full(
                (x.shape[1],), _extreme(at, False), dtype=at, device=x.device)
        outs.append(out)
    return tuple(outs)


def _extreme(dtype, biggest: bool):
    if dtype.is_floating_point:
        return float("inf") if biggest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if biggest else info.min


def fused_summary_ref(x):
    return fused_apply_agg_ref(
        x, tuple((u, a, "float32") for u, a in SUMMARY_CHAINS))


def kmeans_assign_ref(x, centers):
    x = x.to(torch.float32)
    c = centers.to(torch.float32)
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1).reshape(1, -1)
    d = x2 - 2.0 * (x @ c.T) + c2                         # (n, k)
    mind, lab = torch.min(d, dim=1)
    onehot = torch.nn.functional.one_hot(lab, c.shape[0]).to(torch.float32)
    return (lab.to(torch.int32), onehot.T @ x, onehot.sum(0),
            mind.sum().reshape(1))


#: Elements of the dense row chunk an SpMM plain version forms at once.
SPMM_CHUNK_ELEMS = 1 << 26


def spmm_dense_ref(cols, vals, ncol, dtype=torch.float32):
    """ELL slab → dense (rows, ncol): the densify every SpMM version shares.
    Padding (col 0, val 0) adds nothing; columns outside [0, ncol) are
    dropped, as the kernels drop them."""
    c = cols.to(torch.int64)
    keep = (c >= 0) & (c < ncol)
    v = torch.where(keep, vals.to(dtype), torch.zeros((), dtype=dtype,
                                                      device=vals.device))
    out = torch.zeros((cols.shape[0], ncol), dtype=dtype, device=vals.device)
    return out.scatter_add_(1, torch.where(keep, c, 0), v)


def _spmm_chunks(n, ncol):
    step = max(1, SPMM_CHUNK_ELEMS // max(1, ncol))
    return ((s, min(n, s + step)) for s in range(0, n, step))


def spmm_gram_ref(cols, vals, ncol, dtype=torch.float32):
    acc = torch.zeros((ncol, ncol), dtype=dtype, device=vals.device)
    for s, e in _spmm_chunks(cols.shape[0], ncol):
        x = spmm_dense_ref(cols[s:e], vals[s:e], ncol, dtype)
        acc += x.T @ x
    return acc


def spmm_xty_ref(cols, vals, y, ncol, dtype=torch.float32):
    acc = torch.zeros((ncol, y.shape[1]), dtype=dtype, device=vals.device)
    for s, e in _spmm_chunks(cols.shape[0], ncol):
        acc += spmm_dense_ref(cols[s:e], vals[s:e], ncol, dtype).T \
            @ y[s:e].to(dtype)
    return acc


def spmm_wgram_ref(cols, vals, w, ncol, dtype=torch.float32):
    w = w.reshape(-1, 1)
    acc = torch.zeros((ncol, ncol), dtype=dtype, device=vals.device)
    for s, e in _spmm_chunks(cols.shape[0], ncol):
        x = spmm_dense_ref(cols[s:e], vals[s:e], ncol, dtype)
        acc += (x * w[s:e].to(dtype)).T @ x
    return acc
