"""Error-feedback int8 gradient compression for the cross-pod hop — the port
of repro/optim/compression.py.

At multi-pod scale the gradient reduction crosses the slowest link, so
each leaf is quantized to int8 with one symmetric per-tensor scale before
it moves, and the quantization error is carried as a bf16 residual and
added back before the next quantization (error feedback: the rounding
averages out over steps instead of biasing them).  Plain torch ops, as the
reference's are plain jnp (no Pallas kernel).

``cross_pod_psum_int8`` reduces over the positions of a mesh's ``pod``
axis, as the reference's does inside ``shard_map``: the gradients and
residuals are ``distributed.sharding.ShardedTensor`` leaves whose local
tensor at each position is that position's own gradient (the ``shard_map``
view), and every position of a pod group gets the group's reduced value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed.sharding import ShardedTensor, note, tree_map


def quantize(x, *, bits: int = 8):
    """Symmetric per-tensor quantization -> (int8 payload, f32 scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


#: Elements of one slice of ``_residual``'s float64 temporaries (128 MB).
RESIDUAL_SLICE = 1 << 24


def _residual(c, q, s):
    """bf16 of c - q·s rounded once to f32, as a fused multiply-add gives
    it — what the reference's compiles to under ``jax.jit``: the
    difference is exact in float64, taken a slice at a time."""
    out = torch.empty(c.shape, dtype=torch.bfloat16, device=c.device)
    cf, qf, of = c.reshape(-1), q.reshape(-1), out.view(-1)
    s64 = s.double()
    for lo in range(0, cf.numel(), RESIDUAL_SLICE):
        sl = slice(lo, lo + RESIDUAL_SLICE)
        of[sl] = (cf[sl].double() - qf[sl].double() * s64).float()
    return out


def dequantize(q, scale):
    return q.float() * scale


def init_error_state(params):
    """bf16 zeros shaped like every leaf (a sharded leaf's laid out as it
    is)."""
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.map(lambda t: torch.zeros(t.shape, dtype=torch.bfloat16,
                                               device=t.device))
        return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
    return tree_map(zeros, params)


def compress_with_feedback(grads, err):
    """(grads + carried error) -> ((q, scale) tree, err'), err' the input
    minus the dequantized output, in bf16."""
    def one(g, e):
        corrected = g.float() + e.float()
        q, s = quantize(corrected)
        return (q, s), _residual(corrected, q, s)

    out = tree_map(one, grads, err)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def _pod_groups(sharding, axis_name: str):
    """The positions of each pod group (equal but for their ``axis_name``
    index), each group in pod order."""
    names = list(sharding.mesh.axis_names)
    if axis_name not in names:
        raise ValueError(f"the mesh has no {axis_name!r} axis ({names})")
    ax = names.index(axis_name)
    size = np.shape(sharding.mesh.devices)[ax]
    return [[pos[:ax] + (k,) + pos[ax + 1:] for k in range(size)]
            for pos in sharding.positions() if pos[ax] == 0]


def cross_pod_psum_int8(grads, err, axis_name: str = "pod"):
    """Reduce gradients across the ``axis_name`` positions in int8 with
    error feedback: (reduced, err') trees of ``ShardedTensor`` laid out as
    ``grads``.

    The quantization scale is shared across the group (the max of the
    positions' amax, one scalar) *before* quantizing — with per-position
    scales the summed payloads could not be dequantized exactly.  The int8
    payloads are summed in int32 in pod order (exact for <= 2^23
    positions); each position keeps its own residual against the shared
    scale as bf16 error feedback."""
    def reduce_one(g: ShardedTensor, e: ShardedTensor):
        red = np.empty(g.shards.shape, dtype=object)
        res = np.empty(g.shards.shape, dtype=object)
        for group in _pod_groups(g.sharding, axis_name):
            dev = g.local(group[0]).device
            corrected = [g.local(p).float() + e.local(p).float()
                         for p in group]
            amax = torch.stack([torch.max(torch.abs(c)).to(dev)
                                for c in corrected]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            total = None
            for p, c in zip(group, corrected):
                s = scale.to(c.device)
                q = torch.clamp(torch.round(c / s), -127, 127)
                res[p] = _residual(c, q, s)
                note("all-reduce-int8", q.numel(), [p], group[0])
                qi = q.to(torch.int32).to(dev)
                total = qi if total is None else total + qi
            value = total.float() * scale
            for p in group:
                note("all-reduce-int8", value.nbytes, [group[0]], p)
                red[p] = value.to(g.local(p).device, copy=True)
        return (ShardedTensor(red, g.sharding, g.shape, torch.float32),
                ShardedTensor(res, g.sharding, g.shape, torch.bfloat16))

    out = tree_map(reduce_one, grads, err)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
