"""Tensor-parallel compute over the mesh's ``model`` axis for the SSM
(mamba2) and hybrid (zamba2) families — what the reference's GSPMD step
does with the Mamba-2 mixer's ``d_inner`` and ``heads`` leaves on
``model``: each mesh position computes its share of every SSM layer, and
the hybrid's shared attention + MLP block by heads and ``d_ff`` columns
(``tensor_parallel``'s attention and MLP parts).

``resolve`` cuts the mixer's ``d_inner``-tagged dims into contiguous
blocks that do not line up with the heads: ``in_proj``'s columns are z |
x | B | C | dt, ``conv_w`` / ``conv_b`` and the conv window's channels
are x | B | C, while ``A_log``, ``dt_bias``, ``D``, ``norm``, ``out_proj``'s
rows and the state cache follow the heads.  Position j computes the heads
[h0, h1) of its block of ``heads`` (all of them where H does not divide
``model``: then every position computes all heads, and position 0's
result is the layer's where ``out_proj`` is not split either), reading
the groups of B and C those heads read (head h reads group h // (H / G)):

==========  =================================================  ===========
step        what position j computes                           over model
==========  =================================================  ===========
train,      ``in_proj``'s z, x and dt columns of its heads and  a gather
prefill     the B and C columns of their groups, and the       of columns,
            matching ``conv_w`` / ``conv_b`` channels,          one sum of
            gathered; its heads' conv, softplus(dt + dt_bias),  squares,
            ``ssm.ssd_chunked`` with its ``A_log``, D·x, its    one sum of
            sum of squares for the gated norm, the norm on its  ``out_proj``
            rows and its rows of ``out_proj``                  partials
decode      the token's projection onto its own block of       gathers of
            ``in_proj``; the conv over its own block of         the token's
            channels of the window cache (rolled and written   projections
            there); its heads' state update in its own block   and conv
            of the state cache; the norm and ``out_proj`` as    outputs,
            above                                              the sums
==========  =================================================  ===========

Decode reads every parameter and cache block where it lies: the token's
projections and conv outputs move (x to the heads that read it, B and C
to every position), never a parameter, and no position reads or writes
another's cache block.  A prefill writes each head's final state and each
channel's conv window from the first position computing it into the
blocks where ``resolve`` lays them out (an ``all-to-all``, or a
position's own write).  The gated norm's mean over ``d_inner`` is the one
place a per-channel op becomes a sum over ``model``: each position's f32
sum of squares, added in model order (``tp_sum``), differs from one
device's mean in rounding only.

The reference hints the mixer's output ``batch|seq|act_inner`` and, under
``seq_parallel``, the carry ``batch|act_seq|embed``; here, as in
``tensor_parallel``, norms, the embedding's sum and the residual stream
stay whole on the row's device.  The hybrid's shared block is gathered
once a step at each position and applied at every group: autograd adds
the applications' gradients into the one gather's, which adds into the
position's one gradient block once a microbatch.  Copies between
positions go to the account (``sharding.note``): the column gathers and
the decode's projections and conv outputs as ``all-gather``, the sums as
``all-reduce``, the prefill's states and windows as ``all-to-all``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from . import hybrid
from . import layers as L
from . import ssm as S
from . import ssm_lm as SL
from . import transformer
from .tensor_parallel import (_all, _attention, _attn_part, _combine,
                              _decode_attention, _embed, _embed_leaves,
                              _final, _grouped, _logits, _loss,
                              _maybe_no_grad, _mlp, _mlp_part, _positions,
                              _range, _run, _take, _to, _write_kv, tp_sum)

#: Families this module computes over ``model``.
FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Heads and the columns they read
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSMPlan:
    """Position j's share of an SSM layer: heads [h0, h1), the groups [g0,
    g1) of B and C they read, ``grp`` the group (from g0) of each head
    where they do not group evenly (None where they do), and [r_lo, r_hi)
    its rows of ``out_proj`` and ``norm`` (channels of the mixer's
    output)."""
    h0: int
    h1: int
    g0: int
    g1: int
    r_lo: int
    r_hi: int
    grp: tuple = None


def ssm_plans(cfg, row, ssm: dict) -> list:
    """Each position's ``SSMPlan`` for a layer's mixer leaves ``ssm``: the
    heads split over ``model`` where their count divides it (the
    reference's ``heads``), else all of them on every position."""
    d_in, H, P, N, G = S.dims(cfg)
    M, rep = len(row.tp), H // G
    plans = []
    for j in range(M):
        h0, h1 = (j * H // M, (j + 1) * H // M) if H % M == 0 else (0, H)
        grp = [h // rep for h in range(h0, h1)]
        r_lo, r_hi = _range(ssm["out_proj"], row, j, 0)
        if not h0 * P <= r_lo < r_hi <= h1 * P:
            raise NotImplementedError(
                f"out_proj's rows [{r_lo}, {r_hi}) lie outside the heads "
                f"[{h0}, {h1}) of position {j}")
        plans.append(SSMPlan(h0, h1, grp[0], grp[-1] + 1, r_lo, r_hi,
                             None if _grouped(grp) else
                             tuple(g - grp[0] for g in grp)))
    return plans


def _conv_spans(cfg, pl: SSMPlan) -> list:
    """The conv channels (x | B | C) of position ``pl``'s heads: x of its
    heads, B and C of their groups."""
    d_in, H, P, N, G = S.dims(cfg)
    return [(pl.h0 * P, pl.h1 * P),
            (d_in + pl.g0 * N, d_in + pl.g1 * N),
            (d_in + G * N + pl.g0 * N, d_in + G * N + pl.g1 * N)]


def _in_spans(cfg, pl: SSMPlan) -> list:
    """``in_proj``'s columns (z | x | B | C | dt) position ``pl``'s heads
    read: z of its heads, the conv channels shifted by d_inner, dt of its
    heads."""
    d_in, H, P, N, G = S.dims(cfg)
    return ([(pl.h0 * P, pl.h1 * P)]
            + [(lo + d_in, hi + d_in) for lo, hi in _conv_spans(cfg, pl)]
            + [(2 * d_in + 2 * G * N + pl.h0, 2 * d_in + 2 * G * N + pl.h1)])


def _merged(spans: list) -> list:
    out = []
    for lo, hi in spans:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _gather_spans(leaf, j: int, spans: list) -> torch.Tensor:
    """Ranges ``spans`` of a leaf's last dim as position j computes with
    them, gathered over ``model`` (and ``data``) from the blocks holding
    them, adjacent ranges as one, concatenated; each range's gradient goes
    back into the blocks it came from."""
    ts = [leaf.at(j, s).gather() for s in _merged(spans)]
    return ts[0] if len(ts) == 1 else torch.cat(ts, -1)


def _ssm_part(cfg, row, ssm: dict, plans: list, decode: bool) -> dict:
    """A layer's mixer over the row's positions: the ``plans``, whether
    its heads split over ``model`` (``heads``: the gated norm's sum of
    squares is then a sum over ``model``), whether ``out_proj``'s rows do
    (``split``: else position 0's output is the layer's) and each
    position's tensors (``p``).  A decode step keeps the leaves (``own``),
    each position reading its own blocks as it needs them."""
    part = {"plans": plans, "heads": S.dims(cfg)[1] % len(row.tp) == 0,
            "split": ssm["out_proj"].model_split()}
    if decode:
        part["own"] = ssm
        return part
    ps = []
    for j, pl in enumerate(plans):
        conv = _conv_spans(cfg, pl)
        with shd.position(row, j):
            ps.append({
                "in_proj": _gather_spans(ssm["in_proj"], j,
                                         _in_spans(cfg, pl)),
                "conv_w": _gather_spans(ssm["conv_w"], j, conv),
                "conv_b": _gather_spans(ssm["conv_b"], j, conv),
                **{k: ssm[k].at(j, (pl.h0, pl.h1)).gather()
                   for k in ("A_log", "dt_bias", "D")},
                "norm": ssm["norm"].at(j, (pl.r_lo, pl.r_hi)).gather(),
                "out_proj": ssm["out_proj"].at(j).gather()})
    part["p"] = ps
    return part


def _by_head(pl: SSMPlan, t: torch.Tensor) -> torch.Tensor:
    """B or C (..., groups g1 - g0, N) as ``ssd_chunked`` reads them for
    position ``pl``'s heads: as they are where the heads group evenly,
    else one group a head."""
    if pl.grp is None:
        return t
    return t.index_select(-2, torch.tensor(pl.grp, device=t.device))


# ---------------------------------------------------------------------------
# The mixer: train and prefill
# ---------------------------------------------------------------------------

def _heads(cfg, pl: SSMPlan, p: dict, h):
    """Position ``pl``'s heads of ``ssm.apply_ssm`` over h (B, S, d) up to
    the gated norm: (y·silu(z) in f32 (B, S, (h1 - h0)·P), the heads'
    final state (B, h1 - h0, P, N) f32, the conv window of its channels
    (B, K - 1, x | B | C) in ``cfg.dtype``)."""
    d_in, H, P, N, G = S.dims(cfg)
    nh = pl.h1 - pl.h0
    nx, nbc = nh * P, (pl.g1 - pl.g0) * N
    B_, Sq, _ = h.shape
    z, xr, Bc, Cc, dt = torch.split(h @ p["in_proj"].to(h.dtype),
                                    [nx, nx, nbc, nbc, nh], dim=-1)
    conv_in = torch.cat([xr, Bc, Cc], dim=-1)
    window = conv_in[:, -(cfg.ssm_conv - 1):].to(L.dtype_of(cfg.dtype))
    conv_out = S._conv_full(conv_in, p["conv_w"].to(h.dtype),
                            p["conv_b"].to(h.dtype))
    xr, Bc, Cc = torch.split(conv_out, [nx, nbc, nbc], dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    pad = (-Sq) % S.CHUNK
    if pad:
        def padf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xr_, dtp_, Bc_, Cc_ = padf(xr), padf(dtp), padf(Bc), padf(Cc)
    else:
        xr_, dtp_, Bc_, Cc_ = xr, dtp, Bc, Cc
    ng = pl.g1 - pl.g0
    y, state = S.ssd_chunked(xr_.reshape(B_, -1, nh, P), dtp_, p["A_log"],
                             _by_head(pl, S.xh_bc(Bc_, ng, N)),
                             _by_head(pl, S.xh_bc(Cc_, ng, N)))
    y = y[:, :Sq] + xr.reshape(B_, Sq, nh, P) * \
        p["D"].float()[None, None, :, None]
    y = y.reshape(B_, Sq, nx).to(h.dtype)
    return y.float() * F.silu(z.float()), state, window


def _out(cfg, pl: SSMPlan, p: dict, yf, var, dtype):
    """The gated norm of position ``pl``'s rows of yf (its heads' y·silu(z))
    with the mean square ``var`` over all of d_inner, into its rows of
    ``out_proj``."""
    P = cfg.ssm_headdim
    yf = yf[..., pl.r_lo - pl.h0 * P:pl.r_hi - pl.h0 * P]
    y = (yf * torch.rsqrt(var + cfg.rms_eps) * p["norm"].float()).to(dtype)
    return y @ p["out_proj"].to(dtype)


def _norm_and_out(cfg, row, part: dict, yfs: list, dtype):
    """The gated norm and ``out_proj`` over the positions: the mean square
    over d_inner from the positions' sums of squares (a sum over ``model``
    in f32) where the heads split, else each position's own; the
    positions' ``out_proj`` partials summed (or position 0's)."""
    d_in = S.dims(cfg)[0]
    var = None
    if part["heads"]:
        sq = []
        for j, yf in enumerate(yfs):
            with shd.position(row, j):
                sq.append(shd.mark((yf * yf).sum(-1, keepdim=True), row, j))
        var = tp_sum(row, sq) / d_in
    outs = []
    for j, (pl, yf) in enumerate(zip(part["plans"], yfs)):
        with shd.position(row, j), _maybe_no_grad(part["split"], j):
            v = var.to(yf.device) if var is not None else \
                (yf * yf).mean(-1, keepdim=True)
            outs.append(shd.mark(_out(cfg, pl, part["p"][j], yf, v, dtype),
                                 row, j))
    return _combine(row, outs, part["split"])


def _first_runs(pieces: list) -> list:
    """(position, lo, hi, offset in its tensor) of runs of a dim's indices,
    each index taken from the first position whose pieces — (lo, hi,
    offset) a range a position — hold it."""
    done, runs = set(), []
    for j, spans in enumerate(pieces):
        for lo, hi, off in spans:
            i = lo
            while i < hi:
                if i in done:
                    i += 1
                    continue
                e = i
                while e < hi and e not in done:
                    e += 1
                runs.append((j, i, e, off + i - lo))
                done.update(range(i, e))
                i = e
    return runs


def _write_prefill(cfg, row, plans: list, cache: dict, states, windows):
    """Each head's final state and each conv channel's window of a prefill
    into the row's blocks of a layer's cache (``RowCache``), from the
    first position computing it: a position's own write where the block is
    its own, else an ``all-to-all``."""
    for j, lo, hi, off in _first_runs([[(pl.h0, pl.h1, 0)] for pl in plans]):
        cache["state"].put((slice(None), slice(lo, hi)),
                           states[j][:, off:off + hi - lo], src=row.tp[j],
                           kind="all-to-all")
    spans = []
    for pl in plans:
        at, mine = 0, []
        for lo, hi in _conv_spans(cfg, pl):
            mine.append((lo, hi, at))
            at += hi - lo
        spans.append(mine)
    for j, lo, hi, off in _first_runs(spans):
        cache["conv"].put((slice(None), slice(None), slice(lo, hi)),
                          windows[j][..., off:off + hi - lo], src=row.tp[j],
                          kind="all-to-all")


def _mixer(cfg, row, part: dict, h, cache=None):
    """One SSM layer's mixer over the row's positions (``ssm.apply_ssm``):
    its output summed over ``model``; with ``cache`` (a prefill's layer of
    the ``RowCache`` tree), each head's final state and each channel's
    conv window written where ``resolve`` lays them."""
    yfs, states, windows = [], [], []
    for j, pl in enumerate(part["plans"]):
        with shd.position(row, j), _maybe_no_grad(part["split"], j):
            yf, state, window = _heads(cfg, pl, part["p"][j], _to(row, h, j))
        yfs.append(shd.mark(yf, row, j))
        states.append(state)
        windows.append(window)
    out = _norm_and_out(cfg, row, part, yfs, h.dtype)
    if cache is not None:
        _write_prefill(cfg, row, part["plans"], cache, states, windows)
    return out


# ---------------------------------------------------------------------------
# The mixer: decode
# ---------------------------------------------------------------------------

def _held(rc, row, j: int, what: str):
    """(position j's own block of a layer's cache over the row's view, the
    global range of each view dim it covers); it must hold all of the
    row's batch rows."""
    got = rc.held(row.tp[j])
    if got is None or got[1][0] != (rc.rows.start, rc.rows.stop):
        raise NotImplementedError(f"position {j}'s {what} block does not "
                                  f"hold the row's batch rows")
    return got


def _mixer_decode(cfg, row, part: dict, h, conv, state):
    """One token through a layer's mixer over the row's positions
    (``ssm.apply_ssm_decode``), each reading and writing its own blocks of
    the layer's conv window (``conv``) and state (``state``, both
    ``RowCache``): returns the output summed over ``model``."""
    d_in, H, P, N, G = S.dims(cfg)
    ssm, dtype, B_ = part["own"], h.dtype, h.shape[0]
    proj = []
    for j in _all(row):
        with shd.position(row, j):
            hj = h.to(row.tp_device(j))
            lo, hi = _range(ssm["in_proj"], row, j, 1)
            proj.append((j, lo, hi,
                         hj @ ssm["in_proj"].at(j).gather().to(dtype)))
    convs = []
    for j in _all(row):
        blk, span = _held(conv, row, j, "conv window")
        lo, hi = span[2]
        with shd.position(row, j):
            win = torch.cat([blk.to(dtype),
                             _take(row, proj, j, d_in + lo, d_in + hi)], 1)
            w = ssm["conv_w"].at(j, (lo, hi)).gather().to(dtype)
            b = ssm["conv_b"].at(j, (lo, hi)).gather().to(dtype)
            out = F.silu((S._conv_sum(win, w) + b)[:, None].float())
            convs.append((j, lo, hi, out.to(dtype)))
            blk.copy_(win[:, 1:])
    yfs = []
    for j, pl in enumerate(part["plans"]):
        blk, span = _held(state, row, j, "state")
        if span[1] != (pl.h0, pl.h1):
            raise NotImplementedError(f"position {j}'s state block holds "
                                      f"heads {span[1]}, not its own")
        nh, ng = pl.h1 - pl.h0, pl.g1 - pl.g0
        c0 = d_in + G * N
        with shd.position(row, j):
            xr = _take(row, convs, j, pl.h0 * P, pl.h1 * P)
            Bc = _take(row, convs, j, d_in + pl.g0 * N, d_in + pl.g1 * N)
            Cc = _take(row, convs, j, c0 + pl.g0 * N, c0 + pl.g1 * N)
            z = _take(row, proj, j, pl.h0 * P, pl.h1 * P)
            dt = _take(row, proj, j, 2 * d_in + 2 * G * N + pl.h0,
                       2 * d_in + 2 * G * N + pl.h1)
            p = {k: ssm[k].at(j, (pl.h0, pl.h1)).gather()
                 for k in ("A_log", "dt_bias", "D")}
            dtp = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
            a = torch.exp(-dtp * torch.exp(p["A_log"].float()))
            xh = xr.reshape(B_, nh, P).float() * dtp[..., None]
            if pl.grp is None:
                Bh, Ch = (t.reshape(B_, ng, N).repeat_interleave(
                    nh // ng, dim=1).float() for t in (Bc, Cc))
            else:
                Bh, Ch = (_by_head(pl, t.reshape(B_, ng, N)).float()
                          for t in (Bc, Cc))
            new = blk * a[:, :, None, None] + xh[..., :, None] * \
                Bh[:, :, None, :]
            y = torch.einsum("bhpn,bhn->bhp", new, Ch)
            y = y + xr.reshape(B_, nh, P).float() * p["D"].float()[None, :,
                                                                  None]
            y = y.reshape(B_, 1, nh * P).to(dtype)
            yfs.append(y.float() * F.silu(z.float()))
            blk.copy_(new)
    part = dict(part, p=[
        {"norm": ssm["norm"].at(j, (pl.r_lo, pl.r_hi)).gather(),
         "out_proj": ssm["out_proj"].at(j).gather()}
        for j, pl in enumerate(part["plans"])])
    return _norm_and_out(cfg, row, part, yfs, dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _plans_of(cfg, row, params: dict) -> list:
    """The layers' ``SSMPlan``s (every layer's leaves share their
    layout), from the first SSM layer."""
    stack, idx, _ = _layer_ids(cfg)[0]
    return ssm_plans(cfg, row, transformer.layer(params[stack], idx)["ssm"])


def _block(cfg, row, stacked: dict, i, plans: list, x, cache=None):
    """SSM layer i (an index of the stacked leaves) of a train step or a
    prefill: x + its mixer over the row's positions."""
    blk = transformer.layer(stacked, i)
    part = _ssm_part(cfg, row, blk["ssm"], plans, decode=False)
    return x + _mixer(cfg, row, part,
                      L.apply_norm(cfg, shd.hint_tree(blk["ln"]), x), cache)


def _block_decode(cfg, row, stacked: dict, i, plans: list, x, cache: dict):
    blk = transformer.layer(stacked, i)
    part = _ssm_part(cfg, row, blk["ssm"], plans, decode=True)
    return x + _mixer_decode(cfg, row, part,
                             L.apply_norm(cfg, shd.hint_tree(blk["ln"]), x),
                             cache["conv"], cache["state"])


def _shared_at(cfg, row, shared: dict, decode: bool = False) -> dict:
    """The hybrid's shared block over the row's positions, gathered once a
    step: its norms whole on the row's device, its attention's and MLP's
    parts (``tensor_parallel._attn_part``, ``_mlp_part``)."""
    return {"ln1": shd.hint_tree(shared["ln1"]),
            "attn": _attn_part(cfg, row, shared["attn"], decode),
            "ln2": shd.hint_tree(shared["ln2"]),
            "mlp": _mlp_part(row, shared["mlp"])}


def _shared_block(cfg, row, sp: dict, x, positions, *, train: bool,
                  attn_impl: str = "auto"):
    """One application of the shared block: (x', each position's (k, v))."""
    a, kvs = _attention(cfg, row, sp["attn"],
                        L.apply_norm(cfg, sp["ln1"], x), positions,
                        train=train, attn_impl=attn_impl)
    x = x + a
    return x + _mlp(cfg, row, sp["mlp"], L.apply_norm(cfg, sp["ln2"], x)), \
        kvs


def _layer_ids(cfg):
    """(stack, index, group or None) of every SSM layer in order, the group
    given after a group's last layer (where the shared block follows)."""
    if cfg.family == "ssm":
        return [("layers", i, None) for i in range(cfg.n_layers)]
    n_groups, every, tail = hybrid.group_shape(cfg)
    ids = [("groups", (g, e), g if e == every - 1 else None)
           for g in range(n_groups) for e in range(every)]
    return ids + [("tail", t, None) for t in range(tail)]


def _cache_of(cache: dict, stack: str, idx) -> dict:
    key = {"layers": "ssm", "groups": "ssm_groups", "tail": "ssm_tail"}[stack]
    return SL.layer_cache(cache[key], idx)


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def forward(cfg, params: dict, batch: dict):
    """``ssm_lm.forward`` / ``hybrid.forward`` of a data row over its
    positions (params a tree of ``sharding.RowLeaf``): (loss, {"loss"}).
    Under ``cfg.remat`` each SSM layer runs under
    ``torch.utils.checkpoint``, gathered inside it; the hybrid's shared
    block is gathered once and kept, as one device keeps it."""
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, batch["tokens"])
    plans = _plans_of(cfg, row, params)
    shared = positions = None
    if cfg.family == "hybrid":
        shared = _shared_at(cfg, row, params["shared"])
        positions = _positions(x, x.shape[1])
    for stack, idx, g in _layer_ids(cfg):
        x = _run(cfg, lambda x_, s=stack, i=idx: _block(
            cfg, row, params[s], i, plans, x_), x)
        if g is not None:
            x = _shared_block(cfg, row, shared, x, positions, train=True)[0]
    h = _final(cfg, row, params["final_norm"], x)
    loss = _loss(cfg, row, params, embs, h, batch["labels"],
                 batch.get("loss_mask"))
    return loss, {"loss": loss}


def prefill(cfg, params: dict, batch: dict, max_len: int, *,
            attn_impl: str = "auto", cache=None):
    """``ssm_lm.prefill`` / ``hybrid.prefill`` of a data row over its
    positions into its ``RowCache`` view ``cache``: each SSM layer's
    states and windows where they lie, the hybrid's K/V of each
    application into its ``apps`` slice (``tensor_parallel._write_kv``),
    its shared block's heads through the flash kernel.  Returns (cache,
    each position's last-position logits over its vocab block)."""
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, batch["tokens"])
    Sq = x.shape[1]
    if cfg.family == "hybrid" and Sq > max_len:
        raise ValueError(f"prefill: {Sq} tokens exceed max_len {max_len}")
    S.check_prompt(cfg, Sq)
    plans = _plans_of(cfg, row, params)
    if cfg.family == "hybrid":
        shared = _shared_at(cfg, row, params["shared"])
        positions = _positions(x, Sq)
    for stack, idx, g in _layer_ids(cfg):
        x = _block(cfg, row, params[stack], idx, plans, x,
                   _cache_of(cache, stack, idx))
        if g is not None:
            x, kvs = _shared_block(cfg, row, shared, x, positions,
                                   train=False, attn_impl=attn_impl)
            _write_kv(row, shared["attn"]["plans"], cache["kv"]["k"][g],
                      cache["kv"]["v"][g], kvs, Sq)
    h = _final(cfg, row, params["final_norm"], x[:, -1:])
    cache["len"].fill_(Sq)
    return cache, _logits(cfg, row, params, embs, h)


def decode(cfg, params: dict, cache: dict, token):
    """``ssm_lm.decode`` / ``hybrid.decode`` of a data row over its
    positions, each reading and writing its own cache blocks.  Returns
    (cache with len + 1, each position's logits over its vocab block)."""
    row = shd.row_of(params)
    embs = _embed_leaves(row, params)
    x = _embed(cfg, row, params, embs, token)
    cur = cache["len"]
    plans = _plans_of(cfg, row, params)
    if cfg.family == "hybrid":
        shared = _shared_at(cfg, row, params["shared"], decode=True)
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for stack, idx, g in _layer_ids(cfg):
        x = _block_decode(cfg, row, params[stack], idx, plans, x,
                          _cache_of(cache, stack, idx))
        if g is not None:
            x = x + _decode_attention(cfg, row, shared["attn"],
                                      L.apply_norm(cfg, shared["ln1"], x),
                                      kc[g], vc[g], cur)
            x = x + _mlp(cfg, row, shared["mlp"],
                         L.apply_norm(cfg, shared["ln2"], x))
    h = _final(cfg, row, params["final_norm"], x)
    return dict(cache, len=cur + 1), _logits(cfg, row, params, embs, h)
