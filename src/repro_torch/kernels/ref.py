"""Plain PyTorch versions of the ported kernels: the correctness contract.

The wrappers use these for tensors on the CPU (the CPU tests), and
``chip_smoke.py`` holds each kernel against them on the card.  They repeat
the reference oracles of repro/kernels/ref.py in PyTorch, except
``kmeans_assign_ref``, which forms distances by the kernel's expansion
(‖x‖² − 2x·c + ‖c‖², repro/kernels/kmeans_assign.py:48-52) so that it stays
within memory at the main path's size: the direct (n, k, p) difference
tensor would not.
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
