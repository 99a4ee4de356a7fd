"""Tensor-parallel compute over the mesh's ``model`` axis for the
transformer family's dense and VLM configs — what the reference's GSPMD
step does with the parameters' ``heads``, ``kv_heads``, ``d_ff`` and
``vocab`` on ``model`` and its activations hinted there (``act_heads``,
``act_ff``): each mesh position computes its share of every matmul.

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
           in training), then its rows of ``wo``
MLP        ``wi`` / ``wg`` on its ``d_ff`` columns, its     one sum
           rows of ``wo``
embedding  the ids in its vocab block, zeros elsewhere      one sum
logits     its vocab block                                  none
loss       its block's max and sum of exp, the gold logit   max and sums
           where it holds it
=========  ===============================================  ==============

Norms, RoPE and the residual stream stay whole on the row's device.  A
part whose leaves ``resolve`` left replicated over ``model`` (heads that do
not divide it, a ``d_ff`` or vocab that does not) is computed whole by
every position, as GSPMD does, and position 0's result is the part's; KV
heads that do not divide ``model`` while the Q heads do are sliced to those
each position's Q heads read.  A replicated leaf that ``data`` shards is
gathered once, at position 0, and broadcast to the others.

Decode reads the cache where the reference lays it out (``batch`` on
``data``, ``kv_seq`` on ``model``): the token's Q and K/V are gathered over
``model`` (small), each position writes the token's K/V into its own block
where it holds slot ``len`` and attends over its own block for all heads,
and each position combines its heads' partials (max, sum, accumulator)
over ``model`` — the softmax over a sharded ``kv_seq`` — into its rows of
``wo``.  No position reads another's cache block.  A prefill computes K/V
by heads and moves them into that layout (``all-to-all``).

Copies between positions are reported to the account (``sharding.note``):
the sums (``all-reduce``), the decode's Q, token K/V and partial gathers
(``all-gather``), the prefill's K/V move (``all-to-all``) and a replicated
leaf's broadcast (``broadcast``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as shd
from . import layers as L
from . import transformer

#: Families whose steps compute over ``model``; every other family runs
#: the storage-only layout.
FAMILIES = ("dense", "vlm")


def active(cfg, row) -> bool:
    """Whether data row ``row`` computes ``cfg`` over ``model``: a
    tensor-parallel family on a row of more than one position."""
    return row is not None and cfg.family in FAMILIES and len(row.tp) > 1


def serves(cfg, row, cache) -> bool:
    """``active``, with every block of the row's part of the bound decode
    cache (``sharding.bind_cache``) on the row's own positions."""
    return active(cfg, row) and all(
        c.local_to_row() for c in (cache["kv"]["k"][0], cache["kv"]["v"][0]))


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

def _layer_at(cfg, row, stacked: dict, i: int, decode: bool = False) -> dict:
    """Layer i's tensors: the norms whole on the row's device, each
    position's attention and MLP tensors, the attention's ``HeadPlan``s,
    and whether ``model`` splits ``wo``'s rows and the MLP (else position
    0's result is the part's).  A decode step takes each position's own
    block of Q, K and V (``own``, unread until projected) and its ``wo``:
    it gathers the token's projections, not the parameters."""
    lay = transformer.layer(stacked, i)
    attn, mlp = lay["attn"], lay["mlp"]
    plans = head_plans(cfg, row, attn)
    if decode:
        parts = {"own": attn,
                 "attn": _leaves_at(row, {"wo": attn["wo"]}, _all(row))}
    else:
        parts = {"attn": _attn_leaves(cfg, row, attn, plans)}
    return {"ln1": shd.hint_tree(lay["ln1"]),
            "ln2": shd.hint_tree(lay["ln2"]), **parts,
            "mlp": _leaves_at(row, mlp, _all(row)),
            "plans": plans,
            "split": attn["wo"].model_split(),
            "ff_split": mlp["wi"].model_split()}


def _attention(cfg, row, blk: dict, h, positions, *, train: bool,
               attn_impl: str = "auto"):
    """The attention's output (summed over ``model``) and each position's
    (k, v) of its KV heads, (B, S, n, hd)."""
    outs, kvs = [], []
    for j, plan in enumerate(blk["plans"]):
        with shd.position(row, j), _maybe_no_grad(blk["split"], j):
            cj, pj = _attn_at(cfg, plan, blk["attn"][j])
            hj = _to(row, h, j)
            pos = positions.to(hj.device)
            if train:
                o, kv = L.attend_train(cj, pj, hj, pos, causal=True)
            else:
                o, kv = L.attend(cj, pj, hj, pos, causal=True,
                                 impl=attn_impl)
            outs.append(shd.mark(_wo(plan, o, pj["wo"]), row, j))
            kvs.append(kv)
    return _combine(row, outs, blk["split"]), kvs


def _mlp(cfg, row, blk: dict, h) -> torch.Tensor:
    parts = []
    for j in _all(row):
        with shd.position(row, j), _maybe_no_grad(blk["ff_split"], j):
            parts.append(shd.mark(L.apply_mlp(cfg, blk["mlp"][j],
                                              _to(row, h, j)), row, j))
    return _combine(row, parts, blk["ff_split"])


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


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def _block(cfg, row, stacked: dict, i: int, x, positions):
    blk = _layer_at(cfg, row, stacked, i)
    a, _ = _attention(cfg, row, blk, L.apply_norm(cfg, blk["ln1"], x),
                      positions, train=True)
    x = x + a
    return x + _mlp(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))


def forward(cfg, params: dict, batch: dict):
    """``transformer.forward`` of a data row over its positions: params a
    tree of ``sharding.RowLeaf`` (``bind_row(..., whole=False)``).  Under
    ``cfg.remat`` each block runs under ``torch.utils.checkpoint``, the
    layer gathered inside it."""
    row = shd.row_of(params)
    patch = batch.get("patch_embs")
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, batch["tokens"], patch)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        if cfg.remat:
            x = checkpoint(
                lambda x_, p_, i=i: _block(cfg, row, stacked, i, x_, p_),
                x, positions, use_reentrant=False)
        else:
            x = _block(cfg, row, stacked, i, x, positions)
    fin = _leaves_at(row, params["final_norm"], [0])[0]
    h = L.apply_norm(cfg, fin, x)
    if patch is not None:
        h = h[:, patch.shape[1]:]            # the text span only (VLM)
    labels, mask = batch["labels"], batch.get("loss_mask")
    if params["embed"]["tok"].model_split():
        loss = _xent(row, params, _logits(cfg, row, params, embs, h),
                     labels, mask)
    else:
        loss = L.xent_loss(L.logits_out(cfg, embs[0], h), labels, mask)
    return loss, {"loss": loss}


def _write_kv(row, plans: list, kc, vc, kvs: list, S: int):
    """Each KV head's K and V of a prefill into the row's blocks of a
    layer's cache (``RowCache``), from the first position computing it: an
    ``all-to-all`` into the sequence-split layout."""
    for j, c0, c1, l0 in _kv_runs(plans):
        k, v = kvs[j]
        key = (slice(None), slice(0, S), slice(c0, c1))
        for cache, t in ((kc, k), (vc, v)):
            cache.put(key, t[:, :, l0:l0 + c1 - c0], src=row.tp[j],
                      kind="all-to-all")


def prefill(cfg, params: dict, tokens, max_len: int, *, patch_embs=None,
            attn_impl: str = "auto", cache=None):
    """``transformer.prefill`` of a data row over its positions: params a
    tree of ``RowLeaf``, ``cache`` the row's ``RowCache`` view of the
    sharded cache.  Returns (cache, each position's last-position logits
    over its vocab block)."""
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, tokens, patch_embs)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["layers"], i)
        a, kvs = _attention(cfg, row, blk, L.apply_norm(cfg, blk["ln1"], x),
                            positions, train=False, attn_impl=attn_impl)
        x = x + a
        _write_kv(row, blk["plans"], kc[i], vc[i], kvs, S)
        x = x + _mlp(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))
    fin = _leaves_at(row, params["final_norm"], [0])[0]
    h = L.apply_norm(cfg, fin, x[:, -1:])
    cache["len"].fill_(S)
    return cache, _logits(cfg, row, params, embs, h)


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
    (B, T, nkv, hd) at the valid positions ``mask`` (T,): the block's max
    and sum of exp (B, 1, H) and its unnormalized output (B, 1, H, hd), in
    f32, the probabilities cast to v's dtype before the product as
    ``layers._grouped_attention`` does."""
    B, S, H, hd = q.shape
    nkv = k.shape[2]
    g = H // nkv
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3).unsqueeze(2)
    vg = v.permute(0, 2, 1, 3).unsqueeze(2)
    s = (qg.float() @ kg.float().transpose(-1, -2)) * (hd ** -0.5)
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = (p.to(v.dtype) @ vg).float()                     # (B,kv,g,S,hd)
    return (m.permute(0, 3, 1, 2).reshape(B, S, H),
            p.sum(-1).permute(0, 3, 1, 2).reshape(B, S, H),
            acc.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd))


def _own_cols(row, attn: dict, h) -> dict:
    """Each position's projection of the token onto its own block of the
    Q, K and V columns: {name: [(lo, hi, tensor (B, 1, hi - lo)) a
    position]}, the parameters read where they lie."""
    out = {"q": [], "k": [], "v": []}
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
                out[name].append((lo, hi, y))
    return out


def _cols_at(row, pieces: list, j: int, n: int) -> torch.Tensor:
    """Columns [0, n) of a projection on position j's device from the
    positions' pieces (its own where it covers them): an ``all-gather`` of
    the token's activations, never of a parameter."""
    lo, hi, own = pieces[j]
    if (lo, hi) == (0, n):
        return own
    parts, at = [], 0
    for src, (a, b, t) in enumerate(pieces):
        if a == at and b > at:
            parts.append((src, t))
            at = b
    return _assemble(row, parts, j)


def _decode_attention(cfg, row, blk: dict, h, kc, vc, cur):
    """One token's attention over the row's blocks of a layer's cache, each
    block read where it lies, each position projecting onto its own
    columns; returns the output summed over ``model``."""
    plans, hd, nh = blk["plans"], cfg.hd, cfg.n_heads
    g = nh // cfg.n_kv_heads
    B = h.shape[0]
    proj = _own_cols(row, blk["own"], h)
    need = [(pl.r_lo // hd, -(-pl.r_hi // hd)) for pl in plans]
    qs, kvs, regions = {}, {}, {}
    for j in _all(row):
        hk, hv = kc.held(row.tp[j]), vc.held(row.tp[j])
        if hk is None:
            continue
        if hk[1][0] != (kc.rows.start, kc.rows.stop):
            raise NotImplementedError("a cache block holds part of the "
                                      "row's batch rows")
        with shd.position(row, j):
            pos = cur.to(row.tp_device(j)).reshape(1, 1).expand(B, 1)
            q = _cols_at(row, proj["q"], j, nh * hd).reshape(B, 1, nh, hd)
            qs[j] = L.rope(q, pos, cfg.rope_theta)
            k, v = (_cols_at(row, proj[w], j, cfg.n_kv_heads * hd)
                    .reshape(B, 1, -1, hd) for w in ("k", "v"))
            kvs[j] = (L.rope(k, pos, cfg.rope_theta), v)
            for cache, t in ((kc, kvs[j][0]), (vc, kvs[j][1])):
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
                kpos = torch.arange(s_lo, s_hi, device=kb.device)
                m, l, acc = _partial(qs[j][:, :, a:b], kb, vb,
                                     kpos <= cur.to(kb.device))
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
            outs.append(out @ blk["attn"][j]["wo"].to(out.dtype))
    return _combine(row, outs, blk["split"])


def decode(cfg, params: dict, cache: dict, token):
    """``transformer.decode`` of a data row over its positions: params a
    tree of ``RowLeaf``, ``cache`` the row's ``RowCache`` view, each
    position reading and writing its own blocks.  Returns (cache with len
    + 1, each position's logits over its vocab block)."""
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, token)
    cur = cache["len"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = _layer_at(cfg, row, params["layers"], i, decode=True)
        x = x + _decode_attention(cfg, row, blk,
                                  L.apply_norm(cfg, blk["ln1"], x),
                                  kc[i], vc[i], cur)
        x = x + _mlp(cfg, row, blk, L.apply_norm(cfg, blk["ln2"], x))
    fin = _leaves_at(row, params["final_norm"], [0])[0]
    h = L.apply_norm(cfg, fin, x)
    return ({"kv": cache["kv"], "len": cur + 1},
            _logits(cfg, row, params, embs, h))
