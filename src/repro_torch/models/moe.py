"""Mixture-of-Experts layer: token-choice top-k routing with capacity, slot
dispatch and a per-token combine — the port of repro/models/moe.py.

The reference's function, step by step: routing per batch row in float32
(softmax, top-k, renormalized weights), GShard positions by a cumsum over
the row's (token, choice) pairs, a keep mask ``pos < C``, dispatch into
per-row expert buffers of ``C`` slots, the expert FFN (GLU or GELU) as
plain batched products, the weighted combine back to the tokens, and
Arctic's dense residual MLP.  Where the reference leans on JAX semantics
the port spells them out:

* top-k ties go to the lower expert index, as ``jax.lax.top_k`` does: a
  stable descending sort (``torch.topk`` promises no order among ties);
* a dropped pair (``pos >= C``) is written nowhere — the reference sends it
  to an out-of-bounds slot under ``mode="drop"``; here it goes to a spare
  slot past the end that nothing reads, since ``index_put_`` raises on an
  out-of-bounds index;
* each slot receives at most one pair, so dispatch is a gather of token
  rows by slot (a set, not an add), and the combine is a per-token gather
  of its k slots summed in ascending expert order — the order of the
  reference's scatter-add over the slot axis — with no float atomics, so
  two runs on the card agree bit for bit.

The buffers are laid out (E, B·C, d) — expert-major, then the batch row,
then the slot — so each expert's FFN is one batched matmul over all rows'
slots; the reference's (B, E, C, d) einsums compute the same products.

Decode (one token a row) is dropless and, in this formulation, runs every
expert over its C = 8 slots, reading every expert's weights each step, as
the reference's function does.

``route_hook``, when set, is called with (sel, keep) of every call — the
selected experts (B, S, k) and the keep mask (B, S·k) — for instrumentation
(chip_smoke.py reads the dropped pairs and compares routes with it).

The load-balancing term is E · Σ_e me_e · pe_e over the call's tokens
(``me`` the mean router probabilities, ``pe`` the share of tokens whose
first choice is e).  The train forward asks for its statistics
(``stats=True``, a ``Balance``) instead of its value: over a mesh each
data row holds a part of the batch, and the rows combine their ``pe``
before the term is taken (``balance_loss``), so the term is the global
batch's, as the reference's SPMD step computes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L
from .base import param

#: Called with (sel, keep) by every ``apply_moe`` when set (instrumentation).
route_hook = None


def init_moe(cfg, gen, stack: int = 0) -> dict:
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    kw = dict(dtype=L._pdt(cfg), stack=stack)
    p = {"router": param(gen, (d, e), ("d_model", "experts"), **kw),
         "wi": param(gen, (e, d, f), ("experts", "d_model", "d_ff"), **kw),
         "wo": param(gen, (e, f, d), ("experts", "d_ff", "d_model"), **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = param(gen, (e, d, f), ("experts", "d_model", "d_ff"),
                        **kw)
    if cfg.dense_residual:
        p["dense"] = L.init_mlp(cfg, gen, stack, cfg.d_ff)
    return p


def _capacity(cfg, tokens: int) -> int:
    """Slots an expert has a batch row: dropless (the worst case) while
    tokens·top_k <= 4096 — decode steps and small tests — else GShard's
    capacity_factor·tokens·top_k / n_experts; a multiple of 8 either way."""
    if tokens * cfg.top_k <= 4096:
        return max(8, -(-tokens * cfg.top_k // 8) * 8)
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def route(cfg, p, x):
    """(gates (B,S,E) f32, weights (B,S,k) f32, sel (B,S,k) int64): the
    softmax over the router's f32 logits, its top k in descending order
    with ties to the lower expert, and their weights renormalized."""
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, sel = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, weights, sel


def _expert_ffn(cfg, p, buf):
    """buf (E, N, d) -> (E, N, d): each expert's MLP over its slots."""
    dt = buf.dtype
    h = buf @ p["wi"].to(dt)
    if "wg" in p:
        g = buf @ p["wg"].to(dt)
        act = (F.silu(g.float()) if cfg.act == "swiglu"
               else F.gelu(g.float(), approximate="tanh"))
        h = act.to(dt) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    return h @ p["wo"].to(dt)


class Balance(NamedTuple):
    """A MoE call's load-balancing statistics: ``me`` (E,) its tokens' mean
    router probabilities (differentiable), ``pe`` (E,) the share of its
    tokens whose first choice each expert is, over ``n`` tokens."""
    me: torch.Tensor
    pe: torch.Tensor
    n: int


def apply_moe(cfg, p, x, *, stats: bool = False):
    """x: (B, S, d) -> ((B, S, d), the load-balancing auxiliary loss), or
    with ``stats`` its ``Balance`` in place of the loss."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    dev = x.device

    gates, weights, sel = route(cfg, p, x)

    # Per-row capacity positions: the pair's rank among the row's earlier
    # pairs (token-major, then choice) that chose the same expert.  The
    # one-hot is laid out (B, E, S·k) so that the cumsum runs along the
    # innermost axis: along the middle one of (B, S·k, E), as the reference
    # writes it, torch's scan took 12.0 of a 19.5 ms qwen3-moe layer on an
    # H100 (examples/torch_moe_probe.py).
    sel_flat = sel.reshape(B, S * k)
    onehot = (sel_flat[:, None, :] == torch.arange(E, device=dev)[:, None]
              ).to(torch.int32)                                 # (B,E,S·k)
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = pos_all.gather(1, sel_flat[:, None, :])[:, 0]         # (B, S·k)
    del onehot, pos_all
    keep = pos < C
    if route_hook is not None:
        route_hook(sel, keep)

    # Slot of each kept pair in the (E, B·C) buffer; a dropped pair's goes
    # to the spare slot E·B·C.
    n_slots = E * B * C
    row = torch.arange(B, device=dev)[:, None]
    slot = torch.where(keep, sel_flat * (B * C) + row * C + pos,
                       n_slots)                                 # (B, S·k)

    # Dispatch: the token row of every slot (B·S, a zero row, for an empty
    # slot), then the rows gathered.
    tok = (row * S + torch.arange(S * k, device=dev) // k).expand(B, S * k)
    slot_tok = torch.full((n_slots + 1,), B * S, dtype=torch.int64,
                          device=dev)
    slot_tok.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xs = torch.cat([x.reshape(B * S, d), x.new_zeros(1, d)])
    buf = xs[slot_tok[:n_slots]].reshape(E, B * C, d)

    out_buf = _expert_ffn(cfg, p, buf)
    del buf

    # Combine: each token gathers its k slots' outputs (a zero row for a
    # dropped pair), scaled by its weights in x's dtype, and adds them in
    # ascending expert order.
    w = (weights.reshape(B, S * k) * keep).to(x.dtype)
    order = sel.argsort(dim=-1, stable=True)                    # (B,S,k)
    slot = slot.reshape(B, S, k).gather(2, order)
    w = w.reshape(B, S, k).gather(2, order)
    outs = torch.cat([out_buf.reshape(n_slots, d), out_buf.new_zeros(1, d)])
    y = None
    for j in range(k):
        term = outs[slot[..., j]] * w[..., j, None]
        y = term if y is None else y + term
    if "dense" in p:
        y = y + L.apply_mlp(cfg, p["dense"], x)
    bal = _balance(gates.reshape(-1, E), sel.reshape(-1, k), E)
    return y, (bal if stats else balance_loss(bal))


def _balance(gates, sel, E) -> Balance:
    me = gates.mean(dim=0)                                       # (E,)
    pe = F.one_hot(sel[:, 0], E).float().mean(dim=0)
    return Balance(me, pe, gates.shape[0])


def balance_loss(bal: Balance, pe=None):
    """Switch/GShard load-balancing auxiliary loss E · Σ me · pe, with the
    batch's ``pe`` in place of the call's when given."""
    pe = bal.pe if pe is None else pe
    return bal.me.shape[0] * torch.sum(bal.me * pe)
