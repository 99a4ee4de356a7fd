"""Tensor-parallel compute over the mesh's ``model`` axis for the
transformer family (dense, MoE, VLM) and the enc-dec family — and, through
``tensor_parallel_ssm``, the SSM and hybrid families — what the
reference's GSPMD step does with the parameters' ``heads``, ``kv_heads``,
``d_ff``, ``experts`` and ``vocab`` on ``model`` and its activations hinted
there (``act_heads``, ``act_ff``, the expert buffers' ``experts``): each
mesh position computes its share of every matmul.

A data row (``sharding.Row``) is one thread; its positions ``row.tp`` are
the positions that share its data coordinates, one a ``model``
coordinate.  The thread issues each position's work on that position's
device (``sharding.position``) with that position's block of each leaf
(``sharding.RowLeaf.at``: its ``model`` block, whole along ``d_model``).
Each sum over ``model`` is an ordinary autograd op (``tp_sum``): the
partials moved to the row's device and added in model order in f32, so
nothing waits in a backward (on one card every position's backward runs on
the card's one autograd thread, where a barrier would deadlock).

=========  ===============================================  ==============
part       what position j computes                         over ``model``
=========  ===============================================  ==============
attention  Q/K/V of its heads (the KV heads its Q heads     one sum
           read), the flash kernel on them in a prefill
           (``blockwise_attention`` or the grouped softmax
           in training), then its rows of ``wo``; the
           enc-dec's encoder and cross-attention are not
           causal, and none of its attentions has RoPE
MLP        ``wi`` / ``wg`` on its ``d_ff`` columns, its     one sum
           rows of ``wo``
MoE        the router's logits of its block of experts;     a gather of
           the row computes the one route (softmax, top-k)  the logits,
           from all of them and gives it to every           one sum
           position; each dispatches, runs and combines
           its own experts' pairs (``moe.apply_experts``)
embedding  the ids in its vocab block, zeros elsewhere      one sum
logits     its vocab block                                  none
loss       its block's max and sum of exp, the gold logit   max and sums
           where it holds it
=========  ===============================================  ==============

Norms, RoPE, the enc-dec's sinusoids and the residual stream stay whole on
the row's device.  A part whose leaves ``resolve`` left replicated over
``model`` (heads that do not divide it, a ``d_ff``, vocab or expert count
that does not) is computed whole by every position, as GSPMD does, and
position 0's result is the part's; KV heads that do not divide ``model``
while the Q heads do are sliced to those each position's Q heads read.  A
replicated leaf that ``data`` shards is gathered once, at position 0, and
broadcast to the others.  Experts are contiguous blocks by position, so
the sum in model order adds a token's slots in ascending expert order, as
one device does.

Decode reads each cache where ``resolve`` lays it out (``batch`` on
``data``; ``kv_seq`` on ``model`` where it divides, else ``kv_heads``):
the token's Q (and K/V) are gathered over ``model`` (small), each position
writes the token's K/V into its own block where it holds slot ``len``,
attends over its own block for the heads it holds, and each position
combines its heads' partials (max, sum, accumulator) over ``model`` — the
softmax over a sharded ``kv_seq``; nothing to combine where the block
holds all of its heads' keys.  The enc-dec's cross-attention reads the
cross cache the same way, writing nothing and masking nothing.  No position
reads another's cache block.  A prefill computes K/V by heads and moves
them into that layout (``all-to-all`` where it is split by sequence, a
position's own write where by heads).

Copies between positions are reported to the account (``sharding.note``):
the sums (``all-reduce``), the decode's Q, token K/V and partial gathers
and the router's logits (``all-gather``), the prefill's K/V move
(``all-to-all``), the route and a replicated leaf (``broadcast``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as shd
from . import encdec
from . import layers as L
from . import moe as M
from . import transformer

#: Families whose steps compute over ``model`` (the SSM and hybrid in
#: ``tensor_parallel_ssm``); a row of one position runs the storage-only
#: layout.
FAMILIES = ("dense", "vlm", "moe", "encdec", "ssm", "hybrid")


def active(cfg, row) -> bool:
    """Whether data row ``row`` computes ``cfg`` over ``model``: a
    tensor-parallel family on a row of more than one position."""
    return row is not None and cfg.family in FAMILIES and len(row.tp) > 1


def _cache_leaves(cache: dict):
    for v in cache.values():
        if isinstance(v, dict):
            yield from _cache_leaves(v)
        elif isinstance(v, shd.RowCache):
            yield v


def serves(cfg, row, cache) -> bool:
    """``active``, with every block of the row's part of the bound decode
    cache (``sharding.bind_cache``) — the family's leaves: K/V, an
    enc-dec's cross K/V, the SSM's conv windows and states, the hybrid's
    of its groups, its tail and its K/V — on the row's own positions."""
    return active(cfg, row) and all(
        c.local_to_row() for c in _cache_leaves(cache))


# ---------------------------------------------------------------------------
# Positions, their leaves, the sums
# ---------------------------------------------------------------------------

def _to(row, x: torch.Tensor, j: int) -> torch.Tensor:
    """The residual-stream tensor ``x`` (whole on every position) as
    position j computes with it; the backward from here on is the row's."""
    return shd.mark(x.to(row.tp_device(j)), row, 0)


def tp_sum(row, parts: list) -> torch.Tensor:
    """Σ over ``model`` of the positions' partials: each moved to the row's
    device and added in model order in f32, then cast back (an
    ``all-reduce`` into every position)."""
    for j, p in enumerate(parts):
        shd.note("all-reduce", p.nbytes, row.tp, row.tp[j], row.index)
    total = None
    for p in parts:
        t = p.to(row.device).float()
        total = t if total is None else total + t
    return total.to(parts[0].dtype)


def _combine(row, parts: list, split: bool) -> torch.Tensor:
    return tp_sum(row, parts) if split else parts[0]


def _leaves_at(row, tree: dict, js) -> list:
    """Position j's tensors of a tree of ``RowLeaf`` for every j in ``js``
    (a dict a position, None for the others): each leaf's block along
    ``model``, whole along ``d_model`` (the whole leaf where ``model`` does
    not split it), gathered over the positions of its ``model``
    coordinate."""
    out = [None] * len(row.tp)
    for j in js:
        with shd.position(row, j):
            out[j] = shd.tree_map(lambda v: v.at(j).gather(), tree)
    return out


def _all(row):
    return range(len(row.tp))


def _maybe_no_grad(split: bool, j: int):
    """A replicated part's positions past 0 compute what position 0 does;
    their result is not the part's, so it takes no gradient."""
    return torch.no_grad() if not split and j else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Position j's heads: Q heads [lo, hi), the KV heads [c_lo, c_hi) they
    read, ``kv`` the KV head (from c_lo) of each Q head where they do not
    group evenly (None where they do), and [r_lo, r_hi) its rows of
    ``wo``."""
    lo: int
    hi: int
    c_lo: int
    c_hi: int
    r_lo: int
    r_hi: int
    kv: tuple = None


def _grouped(kv: list) -> bool:
    """Whether Q heads reading the KV heads ``kv`` (one a Q head, in order)
    group evenly: each KV head read by as many consecutive Q heads."""
    n, nc = len(kv), len(set(kv))
    return n % nc == 0 and kv == [kv[0] + i // (n // nc) for i in range(n)]


def _range(leaf, row, j: int, dim: int) -> tuple:
    """(lo, hi) of position j's block of a layer leaf's dim ``dim``."""
    sl = leaf.leaf.sharding.slices(leaf.leaf.shape, row.tp[j])
    s = sl[len(leaf.index) + dim]
    return s.start, s.stop


def head_plans(cfg, row, attn: dict) -> list:
    """Each position's ``HeadPlan``: the Q heads split over ``model`` where
    their count divides it (the reference's ``act_heads``), else all of
    them on every position; the KV heads those read; the rows of ``wo``
    its block holds."""
    M, nh, nkv = len(row.tp), cfg.n_heads, cfg.n_kv_heads
    g = nh // nkv
    plans = []
    for j in range(M):
        lo, hi = (j * nh // M, (j + 1) * nh // M) if nh % M == 0 \
            else (0, nh)
        kv = [h // g for h in range(lo, hi)]
        c_lo, c_hi = kv[0], kv[-1] + 1
        plans.append(HeadPlan(lo, hi, c_lo, c_hi,
                              *_range(attn["wo"], row, j, 0),
                              None if _grouped(kv) else
                              tuple(c - c_lo for c in kv)))
    return plans


def _attn_leaves(cfg, row, attn: dict, plans: list) -> list:
    """Each position's attention tensors: Q's columns of its heads, K's and
    V's of the KV heads they read (gathered over ``model`` too where
    ``model`` splits them otherwise), its block of ``wo``."""
    hd, out = cfg.hd, []
    for j, pl in enumerate(plans):
        span = {"wq": (pl.lo, pl.hi), "bq": (pl.lo, pl.hi),
                "wk": (pl.c_lo, pl.c_hi), "bk": (pl.c_lo, pl.c_hi),
                "wv": (pl.c_lo, pl.c_hi), "bv": (pl.c_lo, pl.c_hi)}
        with shd.position(row, j):
            out.append({k: v.at(j, (span[k][0] * hd, span[k][1] * hd)
                                if k in span else None).gather()
                        for k, v in attn.items()})
    return out


def _attn_at(cfg, plan: HeadPlan, p: dict):
    """(config, parameters) of position ``plan``'s attention: the dense
    layer's own functions on fewer heads compute its share; where its Q
    heads do not group evenly over its KV heads, K and V take one copy of
    a KV head's columns a Q head."""
    hd = cfg.hd
    n = plan.hi - plan.lo
    q = dict(p)
    if plan.kv is not None:
        for k in ("wk", "wv", "bk", "bv"):
            if k in p:
                idx = torch.tensor(plan.kv, device=p[k].device)
                q[k] = p[k].unflatten(-1, (-1, hd)).index_select(
                    -2, idx).flatten(-2)
    nkv = plan.c_hi - plan.c_lo if plan.kv is None else n
    return dataclasses.replace(cfg, n_heads=n, n_kv_heads=nkv,
                               head_dim=hd), q


def _wo(plan: HeadPlan, out: torch.Tensor, wo: torch.Tensor):
    """The heads' output (B, S, (hi - lo)·hd) into position ``plan``'s rows
    of ``wo``."""
    lo = plan.lo * (out.shape[-1] // (plan.hi - plan.lo))
    out = out[..., plan.r_lo - lo:plan.r_hi - lo]
    return out @ wo.to(out.dtype)


def _kv_runs(plans: list) -> list:
    """(position, first KV head, end, its index in the position's K/V) of
    runs of KV heads, each KV head taken from the first position that
    computes it."""
    runs, done = [], set()
    for j, pl in enumerate(plans):
        local = ({c: c - pl.c_lo for c in range(pl.c_lo, pl.c_hi)}
                 if pl.kv is None else
                 {pl.c_lo + c: pl.kv.index(c) for c in sorted(set(pl.kv))})
        for c in sorted(local):
            if c in done:
                continue
            done.add(c)
            if runs and runs[-1][0] == j and runs[-1][2] == c and \
                    runs[-1][3] + (c - runs[-1][1]) == local[c]:
                runs[-1] = (j, runs[-1][1], c + 1, runs[-1][3])
            else:
                runs.append((j, c, c + 1, local[c]))
    return runs


# ---------------------------------------------------------------------------
# The parts of a layer
# ---------------------------------------------------------------------------

#: The attention parts of a layer: the transformer's, the enc-dec
#: decoder's self- and cross-attention.
_ATTENTION = ("attn", "self", "cross")


def _attn_part(cfg, row, attn: dict, decode: bool) -> dict:
    """An attention's ``HeadPlan``s, whether ``model`` splits ``wo``'s rows
    (else position 0's result is the part's) and each position's tensors
    (``p``).  A decode step takes each position's own block of Q, K and V
    (``own``, unread until projected) and its ``wo``: it gathers the
    token's projections, not the parameters."""
    plans = head_plans(cfg, row, attn)
    part = {"plans": plans, "split": attn["wo"].model_split()}
    if decode:
        part["own"] = attn
        part["p"] = _leaves_at(row, {"wo": attn["wo"]}, _all(row))
    else:
        part["p"] = _attn_leaves(cfg, row, attn, plans)
    return part


def _mlp_part(row, mlp: dict) -> dict:
    return {"p": _leaves_at(row, mlp, _all(row)),
            "split": mlp["wi"].model_split()}


def _moe_part(row, moe: dict) -> dict:
    """Each position's router columns and experts (``p``), its experts
    [lo, hi) (``spans``) and whether ``model`` splits them; where it does
    not, every position holds all of them whole (and the router only
    position 0, whose logits are the route's).  Arctic's dense residual
    MLP is a part of its own."""
    wi = moe["wi"]
    E = wi.shape[0]
    split = _range(wi, row, 0, 0) != (0, E)
    ps = [None] * len(row.tp)
    for j in _all(row):
        with shd.position(row, j):
            ps[j] = {k: (v.at(j) if split else
                         v.at(j, (0, v.shape[-1]))).gather()
                     for k, v in moe.items()
                     if k != "dense" and (k != "router" or split or not j)}
    part = {"p": ps, "split": split,
            "spans": [_range(wi, row, j, 0) if split else (0, E)
                      for j in _all(row)]}
    if "dense" in moe:
        part["dense"] = _mlp_part(row, moe["dense"])
    return part


def _layer_at(cfg, row, stacked: dict, i: int, decode: bool = False) -> dict:
    """Layer i's tensors: the norms (``ln*``) whole on the row's device,
    each attention's, MLP's and MoE's part (``_attn_part``, ``_mlp_part``,
    ``_moe_part``)."""
    blk = {}
    for k, v in transformer.layer(stacked, i).items():
        if k.startswith("ln"):
            blk[k] = shd.hint_tree(v)
        elif k in _ATTENTION:
            blk[k] = _attn_part(cfg, row, v, decode)
        elif k == "mlp":
            blk[k] = _mlp_part(row, v)
        elif k == "moe":
            blk[k] = _moe_part(row, v)
    return blk


def _attention(cfg, row, part: dict, h, positions, *, train: bool,
               attn_impl: str = "auto", causal: bool = True,
               use_rope: bool = True, xkv=None, kv_positions=None):
    """The attention's output (summed over ``model``) and each position's
    (k, v) of its KV heads, (B, T, n, hd): self-attention over h, or
    cross-attention over ``xkv`` at ``kv_positions``."""
    outs, kvs = [], []
    for j, plan in enumerate(part["plans"]):
        with shd.position(row, j), _maybe_no_grad(part["split"], j):
            cj, pj = _attn_at(cfg, plan, part["p"][j])
            hj = _to(row, h, j)
            kw = dict(causal=causal, use_rope=use_rope,
                      xkv=None if xkv is None else _to(row, xkv, j),
                      kv_positions=None if kv_positions is None else
                      kv_positions.to(hj.device))
            pos = positions.to(hj.device)
            if train:
                o, kv = L.attend_train(cj, pj, hj, pos, **kw)
            else:
                o, kv = L.attend(cj, pj, hj, pos, impl=attn_impl, **kw)
            outs.append(shd.mark(_wo(plan, o, pj["wo"]), row, j))
            kvs.append(kv)
    return _combine(row, outs, part["split"]), kvs


def _mlp(cfg, row, part: dict, h) -> torch.Tensor:
    parts = []
    for j in _all(row):
        with shd.position(row, j), _maybe_no_grad(part["split"], j):
            parts.append(shd.mark(L.apply_mlp(cfg, part["p"][j],
                                              _to(row, h, j)), row, j))
    return _combine(row, parts, part["split"])


def _route(cfg, row, part: dict, h):
    """``moe.route_logits`` of the positions' router logits (each its block
    of experts' columns, or position 0's of all of them), gathered onto
    the row's device: one route a row, which no two positions can
    compute differently."""
    pieces = []
    for j in (_all(row) if part["split"] else [0]):
        with shd.position(row, j):
            lg = _to(row, h, j).float() @ part["p"][j]["router"].float()
            pieces.append((j, shd.mark(lg, row, j)))
    return M.route_logits(cfg, _assemble(row, pieces, 0, dim=-1))


def _moe(cfg, row, part: dict, h):
    """The MoE layer: (its output summed over ``model``, its
    ``moe.Balance`` from the row's route).  Each position takes the route
    (a ``broadcast``) and computes its experts' pairs; the keep mask of
    every pair goes to ``moe.route_hook`` when set."""
    E, k = cfg.n_experts, cfg.top_k
    gates, weights, sel = _route(cfg, row, part, h)
    ys, keeps = [], []
    for j in _all(row):
        with shd.position(row, j), _maybe_no_grad(part["split"], j):
            dev = row.tp_device(j)
            if j:
                for t in (sel, weights):
                    shd.note("broadcast", t.nbytes, [row.pos], row.tp[j],
                             row.index)
            lo, hi = part["spans"][j]
            y, keep = M.apply_experts(cfg, part["p"][j], _to(row, h, j),
                                      sel.to(dev), weights.to(dev), lo, hi)
            ys.append(shd.mark(y, row, j))
            keeps.append(keep)
    if M.route_hook is not None:
        keep = keeps[0].to(row.device)
        for kp in keeps[1:] if part["split"] else []:
            keep = keep | kp.to(row.device)
        M.route_hook(sel, keep)
    y = _combine(row, ys, part["split"])
    if "dense" in part:
        y = y + _mlp(cfg, row, part["dense"], h)
    return y, M._balance(gates.reshape(-1, E), sel.reshape(-1, k), E)


def _ffn(cfg, row, blk: dict, h):
    """The block's second half: (the MoE layer or the MLP of h, the MoE's
    ``Balance`` or None)."""
    if "moe" in blk:
        return _moe(cfg, row, blk["moe"], h)
    return _mlp(cfg, row, blk["mlp"], h), None


def _balance_loss(row, bal):
    """A MoE layer's load-balancing term with the first-choice shares of
    every data row's tokens (``Row.gather_sum``), as
    ``transformer._scan_blocks`` takes it."""
    return M.balance_loss(bal, row.gather_sum(bal.pe * bal.n)
                          / row.gather_sum(bal.n))


def _vocab_lo(leaf, row, j: int) -> int:
    """The first vocab id of position j's block of the embedding table."""
    return leaf.leaf.sharding.slices(leaf.leaf.shape, row.tp[j])[0].start


def _embed(cfg, row, params: dict, embs: list, tokens, patch_embs=None):
    """Token embeddings (after the patch embeddings when given): each
    position looks up the ids in its vocab block (zeros elsewhere) and the
    lookups are summed, exactly the whole table's lookup."""
    tokens = tokens.to(torch.int32)
    if not params["embed"]["tok"].model_split():
        x = L.embed_tokens(cfg, embs[0], tokens)
    else:
        parts = []
        for j in _all(row):
            with shd.position(row, j):
                tok = embs[j]["tok"]
                n = tok.shape[0]
                ids = tokens.to(tok.device).long() - _vocab_lo(
                    params["embed"]["tok"], row, j)
                ok = (ids >= 0) & (ids < n)
                e = L.embed_tokens(cfg, {"tok": tok}, ids.clamp(0, n - 1))
                parts.append(shd.mark(torch.where(ok[..., None], e, 0),
                                      row, j))
        x = tp_sum(row, parts)
    if patch_embs is not None:
        x = torch.cat([patch_embs.to(x.dtype), x], dim=1)
    return x


def _embed_leaves(row, params: dict) -> list:
    """Each position's embedding tensors (position 0's alone where the
    vocab is not split), gathered once a step: the lookup and the logits
    both read them."""
    emb = params["embed"]
    js = _all(row) if emb["tok"].model_split() else [0]
    return _leaves_at(row, emb, js)


def _logits(cfg, row, params: dict, embs: list, h) -> list:
    """Each position's logits over its vocab block; where the vocab is not
    split, position 0's over the whole vocab (None for the others)."""
    out = []
    for j in _all(row):
        if embs[j] is None:
            out.append(None)
            continue
        with shd.position(row, j):
            out.append(shd.mark(L.logits_out(cfg, embs[j], _to(row, h, j)),
                                row, j))
    return out


def _xent(row, params: dict, parts: list, labels, mask=None):
    """``layers.xent_loss`` over logits split over ``model``: each
    position's block's max (the max over ``model``) and sum of exp (summed
    over ``model``), the gold logit from the position whose block holds
    it: the f32 log-sum-exp minus the gold logit, its (masked) mean."""
    dev, labels = row.device, labels.long()
    lfs, mx = [], []
    for j, p in enumerate(parts):
        with shd.position(row, j):
            lfs.append(p.float())
            mx.append(lfs[-1].detach().amax(-1))
    for j, m in enumerate(mx):
        shd.note("all-reduce", m.nbytes, row.tp, row.tp[j], row.index)
    gmax = torch.stack([m.to(dev) for m in mx]).amax(0)
    sums, golds = [], []
    for j, lf in enumerate(lfs):
        with shd.position(row, j):
            n = lf.shape[-1]
            lab = labels.to(lf.device) - _vocab_lo(params["embed"]["tok"],
                                                   row, j)
            ok = (lab >= 0) & (lab < n)
            s = torch.exp(lf - gmax.to(lf.device)[..., None]).sum(-1)
            gold = lf.gather(-1, lab.clamp(0, n - 1)[..., None])[..., 0]
            sums.append(shd.mark(s, row, j))
            golds.append(shd.mark(torch.where(ok, gold, 0.0), row, j))
    total = tp_sum(row, sums)
    gold = tp_sum(row, golds)
    nll = torch.log(total) + gmax - gold
    if mask is None:
        return nll.mean()
    mask = mask.float().to(dev)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _loss(cfg, row, params: dict, embs: list, h, labels, mask=None):
    """The LM loss of the final hidden states h: ``_xent`` over the
    positions' vocab blocks, or ``layers.xent_loss`` of position 0's
    whole-vocab logits where the vocab is not split."""
    if params["embed"]["tok"].model_split():
        return _xent(row, params, _logits(cfg, row, params, embs, h),
                     labels, mask)
    return L.xent_loss(L.logits_out(cfg, embs[0], h), labels, mask)


def _final(cfg, row, tree: dict, x):
    """A final norm (``final_norm``, ``enc_norm``, ``dec_norm``) of x on the
    row's device."""
    return L.apply_norm(cfg, _leaves_at(row, tree, [0])[0], x)


def _run(cfg, fn, *args):
    """``fn(*args)``, under ``cfg.remat`` inside ``torch.utils.checkpoint``
    (the layer gathered inside it, so the backward gathers it again)."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _positions(x, n: int):
    B = x.shape[0]
    return torch.arange(n, dtype=torch.int32, device=x.device)[None].expand(
        B, n)


# ---------------------------------------------------------------------------
# The steps: the transformer family
# ---------------------------------------------------------------------------

def _block(cfg, row, stacked: dict, i: int, x, positions):
    blk = _layer_at(cfg, row, stacked, i)
    a, _ = _attention(cfg, row, blk["attn"],
                      L.apply_norm(cfg, blk["ln1"], x), positions,
                      train=True)
    x = x + a
    m, bal = _ffn(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))
    return x + m, bal


def _forward_lm(cfg, params: dict, batch: dict, terms: bool = False):
    row = shd.row_of(params)
    patch = batch.get("patch_embs")
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, batch["tokens"], patch)
    positions = _positions(x, x.shape[1])
    aux = 0.0
    for i in range(cfg.n_layers):
        x, bal = _run(cfg, lambda x_, p_, i=i: _block(
            cfg, row, params["layers"], i, x_, p_), x, positions)
        if bal is not None:
            aux = aux + _balance_loss(row, bal)
    h = _final(cfg, row, params["final_norm"], x)
    if patch is not None:
        h = h[:, patch.shape[1]:]            # the text span only (VLM)
    loss = _loss(cfg, row, params, embs, h, batch["labels"],
                 batch.get("loss_mask"))
    if cfg.n_experts:
        if terms:
            return loss, 0.01 * aux / cfg.n_layers
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"loss": loss}


def _write_kv(row, plans: list, kc, vc, kvs: list, S: int):
    """Each KV head's K and V of a prefill into the row's blocks of a
    layer's cache (``RowCache``), from the first position computing it: an
    ``all-to-all`` into the sequence-split layout, a position's own write
    into the head-split one."""
    for j, c0, c1, l0 in _kv_runs(plans):
        k, v = kvs[j]
        key = (slice(None), slice(0, S), slice(c0, c1))
        for cache, t in ((kc, k), (vc, v)):
            cache.put(key, t[:, :, l0:l0 + c1 - c0], src=row.tp[j],
                      kind="all-to-all")


def _prefill_lm(cfg, params: dict, batch: dict, max_len: int, attn_impl,
                cache):
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, batch["tokens"],
               batch.get("patch_embs"))
    S = x.shape[1]
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    positions = _positions(x, S)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["layers"], i)
        a, kvs = _attention(cfg, row, blk["attn"],
                            L.apply_norm(cfg, blk["ln1"], x), positions,
                            train=False, attn_impl=attn_impl)
        x = x + a
        _write_kv(row, blk["attn"]["plans"], kc[i], vc[i], kvs, S)
        x = x + _ffn(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))[0]
    h = _final(cfg, row, params["final_norm"], x[:, -1:])
    cache["len"].fill_(S)
    return cache, _logits(cfg, row, params, embs, h)


def _decode_lm(cfg, params: dict, cache: dict, token):
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, token)
    cur = cache["len"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["layers"], i, decode=True)
        x = x + _decode_attention(cfg, row, blk["attn"],
                                  L.apply_norm(cfg, blk["ln1"], x),
                                  kc[i], vc[i], cur)
        x = x + _ffn(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))[0]
    h = _final(cfg, row, params["final_norm"], x)
    return ({"kv": cache["kv"], "len": cur + 1},
            _logits(cfg, row, params, embs, h))


# ---------------------------------------------------------------------------
# The steps: the enc-dec family
# ---------------------------------------------------------------------------

def _enc_block(cfg, row, stacked: dict, i: int, x, pos, *, train: bool,
               attn_impl: str = "auto"):
    blk = _layer_at(cfg, row, stacked, i)
    a, _ = _attention(cfg, row, blk["attn"],
                      L.apply_norm(cfg, blk["ln1"], x), pos, train=train,
                      attn_impl=attn_impl, causal=False, use_rope=False)
    x = x + a
    return x + _mlp(cfg, row, blk["mlp"], L.apply_norm(cfg, blk["ln2"], x))


def _encode(cfg, row, params: dict, frames, *, train: bool,
            attn_impl: str = "auto"):
    """(the normed encoder output, its positions): each position its heads
    of every encoder block."""
    x, pos = encdec._enc_input(cfg, frames)
    for i in range(cfg.n_enc_layers):
        def body(x_, p_, i=i):
            return _enc_block(cfg, row, params["enc_layers"], i, x_, p_,
                              train=train, attn_impl=attn_impl)
        x = _run(cfg, body, x, pos) if train else body(x, pos)
    return _final(cfg, row, params["enc_norm"], x), pos


def _dec_block(cfg, row, blk: dict, x, pos, enc_out, enc_pos, *,
               train: bool, attn_impl: str = "auto"):
    """One decoder block: (x', each position's (k, v) of its
    self-attention, of its cross-attention over ``enc_out``)."""
    a, kvs = _attention(cfg, row, blk["self"],
                        L.apply_norm(cfg, blk["ln1"], x), pos, train=train,
                        attn_impl=attn_impl, use_rope=False)
    x = x + a
    c, cross = _attention(cfg, row, blk["cross"],
                          L.apply_norm(cfg, blk["ln2"], x), pos,
                          train=train, attn_impl=attn_impl, causal=False,
                          use_rope=False, xkv=enc_out, kv_positions=enc_pos)
    x = x + c
    x = x + _mlp(cfg, row, blk["mlp"], L.apply_norm(cfg, blk["ln3"], x))
    return x, kvs, cross


def _dec_input(cfg, row, params: dict, embs: list, tokens, pos):
    """``encdec._dec_input`` over the positions' vocab blocks."""
    x = _embed(cfg, row, params, embs, tokens)
    return x + L.sinusoidal(pos.to(x.device), cfg.d_model).to(x.dtype)


def _forward_encdec(cfg, params: dict, batch: dict):
    row = shd.row_of(params)
    enc_out, epos = _encode(cfg, row, params, batch["frames"], train=True)
    tokens = batch["tokens"]
    pos = _positions(enc_out, tokens.shape[1])
    embs = _embed_leaves(row, params)
    x = _dec_input(cfg, row, params, embs, tokens, pos)
    for i in range(cfg.n_layers):
        def body(x_, p_, e_, ep_, i=i):
            blk = _layer_at(cfg, row, params["dec_layers"], i)
            return _dec_block(cfg, row, blk, x_, p_, e_, ep_, train=True)[0]
        x = _run(cfg, body, x, pos, enc_out, epos)
    h = _final(cfg, row, params["dec_norm"], x)
    loss = _loss(cfg, row, params, embs, h, batch["labels"])
    return loss, {"loss": loss}


def _prefill_encdec(cfg, params: dict, batch: dict, max_len: int,
                    attn_impl, cache):
    row = shd.row_of(params)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    enc_out, epos = _encode(cfg, row, params, batch["frames"], train=False,
                            attn_impl=attn_impl)
    F_ = enc_out.shape[1]
    pos = _positions(enc_out, S)
    embs = _embed_leaves(row, params)
    x = _dec_input(cfg, row, params, embs, tokens, pos)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["dec_layers"], i)
        x, kvs, cross = _dec_block(cfg, row, blk, x, pos, enc_out, epos,
                                   train=False, attn_impl=attn_impl)
        _write_kv(row, blk["self"]["plans"], kc[i], vc[i], kvs, S)
        _write_kv(row, blk["cross"]["plans"], cache["cross_k"][i],
                  cache["cross_v"][i], cross, F_)
    h = _final(cfg, row, params["dec_norm"], x[:, -1:])
    cache["len"].fill_(S)
    return cache, _logits(cfg, row, params, embs, h)


def _decode_encdec(cfg, params: dict, cache: dict, token):
    row = shd.row_of(params)
    cur = cache["len"]
    embs = _embed_leaves(row, params)
    x = _dec_input(cfg, row, params, embs, token,
                   cur.reshape(1, 1).expand(token.shape[0], 1))
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["dec_layers"], i, decode=True)
        x = x + _decode_attention(cfg, row, blk["self"],
                                  L.apply_norm(cfg, blk["ln1"], x),
                                  kc[i], vc[i], cur, rope=False)
        x = x + _decode_attention(cfg, row, blk["cross"],
                                  L.apply_norm(cfg, blk["ln2"], x),
                                  cache["cross_k"][i], cache["cross_v"][i],
                                  cur, rope=False, cross=True)
        x = x + _mlp(cfg, row, blk["mlp"], L.apply_norm(cfg, blk["ln3"], x))
    h = _final(cfg, row, params["dec_norm"], x)
    return ({"kv": cache["kv"], "cross_k": cache["cross_k"],
             "cross_v": cache["cross_v"], "len": cur + 1},
            _logits(cfg, row, params, embs, h))


# ---------------------------------------------------------------------------
# Decode attention over the row's cache blocks
# ---------------------------------------------------------------------------

def _assemble(row, pieces: list, j: int, dim: int = 2) -> torch.Tensor:
    """Pieces (position, tensor) concatenated along ``dim`` on position
    j's device: an ``all-gather`` of the pieces other positions hold."""
    dev = row.tp_device(j)
    parts = []
    for src, t in pieces:
        if src != j:
            shd.note("all-gather", t.nbytes, [row.tp[src]], row.tp[j],
                     row.index)
        parts.append(t.to(dev))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _partial(q, k, v, mask):
    """Softmax attention of q (B, 1, H, hd) over one block's keys k / v
    (B, T, nkv, hd) at the valid positions ``mask`` (T,; None: all): the
    block's max and sum of exp (B, 1, H) and its unnormalized output (B,
    1, H, hd), in f32, the probabilities cast to v's dtype before the
    product as ``layers._grouped_attention`` does."""
    B, S, H, hd = q.shape
    nkv = k.shape[2]
    g = H // nkv
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3).unsqueeze(2)
    vg = v.permute(0, 2, 1, 3).unsqueeze(2)
    s = (qg.float() @ kg.float().transpose(-1, -2)) * (hd ** -0.5)
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    acc = (p.to(v.dtype) @ vg).float()                     # (B,kv,g,S,hd)
    return (m.permute(0, 3, 1, 2).reshape(B, S, H),
            p.sum(-1).permute(0, 3, 1, 2).reshape(B, S, H),
            acc.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd))


def _own_cols(row, attn: dict, h, names) -> dict:
    """Each position's projection of the token onto its own block of the
    columns of each of ``names`` (of ``q``, ``k``, ``v``): {name:
    [(position, lo, hi, tensor (B, 1, hi - lo))]}, the parameters read
    where they lie."""
    out = {name: [] for name in names}
    for j in _all(row):
        with shd.position(row, j):
            hj = h.to(row.tp_device(j))
            for name in out:
                leaf = attn["w" + name]
                w = leaf.at(j).gather()
                y = hj @ w.to(hj.dtype)
                if "b" + name in attn:
                    y = y + attn["b" + name].at(j).gather().to(hj.dtype)
                lo, hi = _range(leaf, row, j, 1)
                out[name].append((j, lo, hi, y))
    return out


def _take(row, pieces: list, j: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of a token's activations on position j's device
    from the pieces (position, lo, hi, tensor) the positions hold: its
    own where they cover a column, else the first that does (an
    ``all-gather`` of activations, never of a parameter)."""
    parts, at = [], lo
    while at < hi:
        got = [pc for pc in pieces if pc[1] <= at < pc[2]]
        if not got:
            raise ValueError(f"no position holds column {at}")
        src, a, b, t = next((pc for pc in got if pc[0] == j), got[0])
        end = min(b, hi)
        parts.append((src, t[..., at - a:end - a]))
        at = end
    return _assemble(row, parts, j, dim=-1)


def _decode_attention(cfg, row, part: dict, h, kc, vc, cur, *,
                      rope: bool = True, cross: bool = False):
    """One token's attention over the row's blocks of a layer's cache
    (``RowCache``), each block read where it lies — split by sequence or
    by heads — each position projecting onto its own columns; returns the
    output summed over ``model``.  Self-attention writes the token's K/V
    at ``cur`` (with RoPE under ``rope``) and attends over positions <=
    ``cur``; cross-attention (``cross``) projects the token's Q alone and
    attends over every key of the cross cache, writing nothing."""
    plans, hd, nh = part["plans"], cfg.hd, cfg.n_heads
    g = nh // cfg.n_kv_heads
    B = h.shape[0]
    proj = _own_cols(row, part["own"], h,
                     ("q",) if cross else ("q", "k", "v"))
    need = [(pl.r_lo // hd, -(-pl.r_hi // hd)) for pl in plans]
    qs, regions = {}, {}
    for j in _all(row):
        hk, hv = kc.held(row.tp[j]), vc.held(row.tp[j])
        if hk is None:
            continue
        if hk[1][0] != (kc.rows.start, kc.rows.stop):
            raise NotImplementedError("a cache block holds part of the "
                                      "row's batch rows")
        with shd.position(row, j):
            pos = cur.to(row.tp_device(j)).reshape(1, 1).expand(B, 1)
            q = _take(row, proj["q"], j, 0, nh * hd).reshape(B, 1, nh, hd)
            qs[j] = L.rope(q, pos, cfg.rope_theta) if rope else q
            if not cross:
                k, v = (_take(row, proj[w], j, 0, cfg.n_kv_heads * hd)
                        .reshape(B, 1, -1, hd) for w in ("k", "v"))
                if rope:
                    k = L.rope(k, pos, cfg.rope_theta)
                for cache, t in ((kc, k), (vc, v)):
                    cache.put_slot(t.to(cache.dtype), 1, cur.to(t.device),
                                   only=row.tp[j], src=row.tp[j])
        regions.setdefault((hk[1][1], hk[1][2]), []).append((j, hk[0],
                                                             hv[0]))
    partials = []            # (position, [a, b) of Q heads, m, l, acc)
    for ((s_lo, s_hi), (c_lo, c_hi)), holders in regions.items():
        a0, b0 = c_lo * g, c_hi * g
        for j, kb, vb in holders:
            a, b = (max(a0, need[j][0]), min(b0, need[j][1])) \
                if len(holders) > 1 else (a0, b0)
            if a >= b:
                continue
            with shd.position(row, j):
                kv = [hh // g - c_lo for hh in range(a, b)]
                if not _grouped(kv):
                    idx = torch.tensor(kv, device=kb.device)
                    kb, vb = kb.index_select(2, idx), vb.index_select(2, idx)
                else:
                    kb, vb = kb[:, :, kv[0]:kv[-1] + 1], \
                        vb[:, :, kv[0]:kv[-1] + 1]
                mask = None if cross else \
                    torch.arange(s_lo, s_hi, device=kb.device) <= \
                    cur.to(kb.device)
                m, l, acc = _partial(qs[j][:, :, a:b], kb, vb, mask)
            partials.append((j, a, b, m, l, acc))
    outs = []
    for j, plan in enumerate(plans):
        lo, hi = need[j]
        with shd.position(row, j):
            got = [p for p in partials if p[1] < hi and lo < p[2]]
            if any(p[1] > lo or p[2] < hi for p in got):
                raise NotImplementedError(
                    "a position's heads straddle two partials")
            ms, ls, accs = [], [], []
            for src, a, b, m, l, acc in got:
                sl = slice(lo - a, hi - a)
                ms.append(_assemble(row, [(src, m[:, :, sl])], j))
                ls.append(_assemble(row, [(src, l[:, :, sl])], j))
                accs.append(_assemble(row, [(src, acc[:, :, sl])], j))
            top = torch.stack(ms).amax(0)
            w = [torch.exp(m - top) for m in ms]
            num = sum(wi[..., None] * a for wi, a in zip(w, accs))
            den = sum(wi * li for wi, li in zip(w, ls))
            out = (num / den[..., None]).to(kc.dtype).reshape(
                B, 1, (hi - lo) * hd)
            out = out[..., plan.r_lo - lo * hd:plan.r_hi - lo * hd]
            outs.append(out @ part["p"][j]["wo"].to(out.dtype))
    return _combine(row, outs, part["split"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(cfg, params: dict, batch: dict, *, terms: bool = False):
    """The family's train forward (``transformer.forward``,
    ``encdec.forward``) of a data row over its positions: params a tree of
    ``sharding.RowLeaf`` (``bind_row(..., whole=False)``), returning (loss,
    {"loss": loss}); a MoE's loss takes each layer's load-balancing term
    over every data row's first-choice shares, and with ``terms`` comes as
    its two terms apart (``transformer.forward``).  Under ``cfg.remat``
    each block runs under ``torch.utils.checkpoint``, the layer gathered
    inside it."""
    if cfg.family in ("ssm", "hybrid"):
        from . import tensor_parallel_ssm
        return tensor_parallel_ssm.forward(cfg, params, batch)
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, batch)
    return _forward_lm(cfg, params, batch, terms)


def prefill(cfg, params: dict, batch: dict, max_len: int, *,
            attn_impl: str = "auto", cache=None):
    """The family's prefill of a data row over its positions (batch:
    tokens [, patch_embs | frames]): params a tree of ``RowLeaf``,
    ``cache`` the row's ``RowCache`` view of the sharded cache.  Returns
    (cache, each position's last-position logits over its vocab block,
    None for a position past 0 where the vocab is not split)."""
    if cfg.family in ("ssm", "hybrid"):
        from . import tensor_parallel_ssm
        return tensor_parallel_ssm.prefill(cfg, params, batch, max_len,
                                           attn_impl=attn_impl, cache=cache)
    fn = _prefill_encdec if cfg.family == "encdec" else _prefill_lm
    return fn(cfg, params, batch, max_len, attn_impl, cache)


def decode(cfg, params: dict, cache: dict, token):
    """The family's decode step of a data row over its positions: params a
    tree of ``RowLeaf``, ``cache`` the row's ``RowCache`` view, each
    position reading and writing its own blocks.  Returns (cache with len
    + 1, each position's logits over its vocab block)."""
    if cfg.family in ("ssm", "hybrid"):
        from . import tensor_parallel_ssm
        return tensor_parallel_ssm.decode(cfg, params, cache, token)
    fn = _decode_encdec if cfg.family == "encdec" else _decode_lm
    return fn(cfg, params, cache, token)
