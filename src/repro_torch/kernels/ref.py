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

Attention has two plain versions, kept apart on purpose because they differ
when causal and S != T: ``flash_attention_ref`` is the Pallas kernel's
function (repro/kernels/flash_attention.py: causal by absolute ids
q_id >= k_id, the finite -1e30, l clamped at 1e-30), which the port's kernel
computes; ``attention_ref`` is the twin of repro/kernels/ref.py's
``attention_ref`` (a bottom-right ``tril(k=T-S)`` mask, -inf).  Both take
(BH, S, D) tensors or (B, nh, S, D) with K/V (B, nkv, T, D), nh a multiple
of nkv (GQA without repeating KV), and form the scores a chunk of heads and
rows at a time (``ATTN_CHUNK_ELEMS``): one layer of the serving path in one
piece would be a 6.4 GB score tensor.
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


#: Scores an attention plain version forms at once.
ATTN_CHUNK_ELEMS = 1 << 26
#: The Pallas kernel's finite mask value (repro/kernels/flash_attention.py:30).
NEG_INF = -1e30


def _heads4(q, k, v):
    """(BH, S, D) → (BH, 1, S, D); (B, nh, S, D) as it is; with the group
    factor g = nh / nkv."""
    if q.ndim == 3:
        q, k, v = q[:, None], k[:, None], v[:, None]
    return q, k, v, q.shape[1] // k.shape[1]


def _attention_chunks(q, k, v, scale, softmax_chunk, dtype):
    q4, k4, v4, g = _heads4(q, k, v)
    B, nh, S, D = q4.shape
    T = k4.shape[2]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    rows = max(1, min(S, ATTN_CHUNK_ELEMS // max(1, T)))
    heads = max(1, min(nh, ATTN_CHUNK_ELEMS // max(1, rows * T)))
    kid = torch.arange(T, device=q.device)
    for b in range(B):
        for h0 in range(0, nh, heads):
            h1 = min(nh, h0 + heads)
            kvh = torch.arange(h0, h1, device=q.device) // g
            kc = k4[b].index_select(0, kvh).to(dtype)
            vc = v4[b].index_select(0, kvh).to(dtype)
            for r0 in range(0, S, rows):
                r1 = min(S, r0 + rows)
                s = (q4[b, h0:h1, r0:r1].to(dtype) @ kc.transpose(1, 2)) * scale
                qid = torch.arange(r0, r1, device=q.device)[:, None]
                out[b, h0:h1, r0:r1] = softmax_chunk(s, qid, kid, S, T, vc).to(
                    q.dtype)
    return out.reshape(q.shape)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None,
                        dtype=torch.float32):
    """The Pallas flash kernel's function: masked scores at -1e30, a full
    softmax with l clamped at 1e-30, (P·V) / l; ``dtype`` float32 as the
    kernel computes (float64 for the checks on the card)."""
    def chunk(s, qid, kid, S, T, vc):
        if causal:
            s = s.masked_fill(qid < kid, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return (p @ vc) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return _attention_chunks(q, k, v, scale, chunk, dtype)


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Twin of repro/kernels/ref.py:attention_ref: causal is the
    bottom-right mask tril(k = T - S) at -inf, softmax normalized before
    the product with V."""
    def chunk(s, qid, kid, S, T, vc):
        if causal:
            s = s.masked_fill(kid > qid + (T - S), float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return (p / p.sum(-1, keepdim=True)) @ vc
    return _attention_chunks(q, k, v, scale, chunk, torch.float32)
