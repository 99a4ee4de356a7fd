"""AdamW with low-precision moments — the port of ``repro.optim.adam``.

Moments default to bfloat16 (half the optimizer memory of f32 moments).
Trees are the reference's: the state is ``{"m": tree, "v": tree, "step"}``
with the parameters' keys, ``step`` a 0-d int32 tensor.

``update`` computes the reference's ``upd_elem`` element for element — f32
math, then casts to the parameter's and the moments' dtypes — and writes
the results into ``params``, ``m`` and ``v`` in place, a slice of rows at a
time: the caller donates them, as the reference's jitted step donates its
arguments.  At llama3.2-3b a full-size f32 temporary of the largest leaf,
(28, 3072, 8192), is 2.8 GB, and the update makes several per term; by
slices the temporaries stay under 256 MB each.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import NamedSharding, ShardedTensor, place

#: Elements of one slice of ``update``'s in-place pass (256 MB of f32).
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "bfloat16"
    grad_clip: float = 1.0


def leaves(tree, prefix=""):
    """(path, leaf) of every leaf in the order JAX flattens a dict: keys
    sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init(params, cfg: AdamConfig = AdamConfig()):
    mdt = getattr(torch, cfg.moment_dtype)
    first = next(leaves(params))[1]

    def zeros_like(t):
        return torch.zeros(t.shape, dtype=mdt, device=t.device)

    if isinstance(first, ShardedTensor):
        def zeros(p):
            return p.map(zeros_like)
        step = place(torch.zeros((), dtype=torch.int32),
                     NamedSharding(first.sharding.mesh, ()))
    else:
        zeros = zeros_like
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": step}


def opt_state_axes(param_axes):
    """Moment trees shard exactly like the parameters."""
    return {"m": param_axes, "v": param_axes, "step": ""}


def global_norm(tree):
    """sqrt of the sum over leaves (in JAX's order) of Σ x² in f32; a
    sharded leaf's Σ over the first copy of each of its blocks, in mesh
    order, on the first block's device."""
    total, dev = 0, None
    for _, x in leaves(tree):
        parts = ([t for _, _, t in x.blocks()]
                 if isinstance(x, ShardedTensor) else [x])
        for t in parts:
            dev = t.device if dev is None else dev
            total = total + torch.sum(torch.square(t.float())).to(dev)
    return torch.sqrt(total)


def _rows_per_slice(p) -> int:
    row = max(1, p.numel() // max(1, p.shape[0]))
    return max(1, SLICE_ELEMS // row)


@torch.no_grad()
def update(grads, state, params, cfg: AdamConfig = AdamConfig(),
           lr_scale=1.0):
    """One AdamW step, in place.  Returns (params, new_state, metrics):
    ``params`` and the state's moment trees are the tensors passed in, now
    holding the new values."""
    old_step = state["step"]
    sharded = isinstance(old_step, ShardedTensor)
    step = old_step.map(lambda t: t + 1) if sharded else old_step + 1
    step1 = step.local(step.sharding.positions()[0]) if sharded else step
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    b1c = 1.0 - cfg.b1 ** step1.float()
    b2c = 1.0 - cfg.b2 ** step1.float()
    lr = cfg.lr * lr_scale
    on_dev = {}

    def consts(dev):
        """(clip, b1c, b2c) on ``dev``."""
        if dev not in on_dev:
            on_dev[dev] = tuple(c.to(dev) if isinstance(c, torch.Tensor)
                                else c for c in (clip, b1c, b2c))
        return on_dev[dev]

    def upd_elem(p, g, m, v, decay):
        clip, b1c, b2c = consts(p.device)
        g = g.float() * clip
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            step_ = step_ + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step_
        p.copy_(new_p)
        m.copy_(m32)
        v.copy_(v32)

    g_of, m_of, v_of = (dict(leaves(t)) for t in (grads, state["m"],
                                                  state["v"]))
    def upd_leaf(p, g, m, v, decay):
        if p.ndim == 0:
            upd_elem(p, g, m, v, decay)
            return
        rows = _rows_per_slice(p)
        for lo in range(0, p.shape[0], rows):
            sl = slice(lo, lo + rows)
            upd_elem(p[sl], g[sl], m[sl], v[sl], decay)

    for key, p in leaves(params):
        g, m, v = g_of[key], m_of[key], v_of[key]
        decay = bool(cfg.weight_decay) and p.ndim >= 2
        if isinstance(p, ShardedTensor):
            for pos in p.sharding.positions():
                upd_leaf(p.local(pos), g.local(pos), m.local(pos),
                         v.local(pos), decay)
        else:
            upd_leaf(p, g, m, v, decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm}
