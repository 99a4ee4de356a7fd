"""Transformer building blocks of the dense LM: norms, RoPE, GQA attention,
GLU MLPs, embedding — the port of repro/models/layers.py's dense parts.

Plain functions over dicts of tensors with the reference's keys, shapes and
(in, out) weight layout, computing what the reference computes step by step
(the same f32 upcasts, the same casts back to the activation dtype).

Attention:
  * prefill (full sequence) goes through ``kernels.ops.attention`` — the
    hand-written flash kernel on the card — with q (B, nh, S, hd) and k, v
    (B, nkv, T, hd), GQA read in the kernel.  The reference computes the same
    softmax attention in jnp (``_grouped_attention``, or its blockwise scan
    for long sequences); its causal mask compares positions, the kernel's
    compares indices, which is the same for a prefill's positions 0 .. S-1.
    The enc-dec family's encoder self-attention and its cross-attention
    (``xkv``: K/V from the encoder output, S != T) are not causal: the
    kernel masks only k < T there, as the reference masks nothing.
  * one-token decode against the static-length KV cache stays plain
    PyTorch, as the reference computes it outside any kernel: write at
    ``cur_len``, attend over positions <= ``cur_len``.  The port writes the
    new K/V into the cache tensors in place (the reference returns a new
    cache; in place saves copying it every step).  Decode-time
    cross-attention over the cached encoder K/V is plain too
    (``apply_cross_attention_decode``).
  * training (``apply_attention_train``) never reaches ``ops.attention``,
    whose kernel has no backward: it computes attention as the reference's
    train forward does, in plain PyTorch — ``_grouped_attention`` under a
    position mask while S·T <= ``_BLOCKWISE_THRESHOLD``², else
    ``blockwise_attention``, the flash-style scan over KV chunks with its
    recompute backward (a ``torch.autograd.Function``, the twin of the
    reference's custom VJP).  Neither is a Pallas kernel in the reference.

``xent_loss`` is the reference's f32 cross-entropy; ``sinusoidal`` its
absolute encodings (the enc-dec family's positions).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from ..kernels import ops
from .base import param


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _pdt(cfg) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, gen, stack: int = 0) -> dict:
    kw = dict(dtype=_pdt(cfg), stack=stack)
    p = {"scale": param(gen, (cfg.d_model,), ("embed",), init="ones", **kw)}
    if cfg.norm == "layernorm":
        p["bias"] = param(gen, (cfg.d_model,), ("embed",), init="zeros",
                          **kw)
    return p


def apply_norm(cfg, p, x):
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.rms_eps)
        out = out * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Half-split
    rotation with the reference's f32 frequencies, exactly as written
    there: exp(-log θ · arange(half) / half)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs             # (..., S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(positions, d: int):
    """Sin/cos absolute encodings: positions (..., S) -> (..., S, d) in f32,
    the reference's formula: frequencies exp(-log(10000) · arange(d/2) /
    (d/2)), the sines then the cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg, gen, stack: int = 0) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(dtype=_pdt(cfg), stack=stack)
    p = {"wq": param(gen, (d, nh * hd), ("d_model", "heads"), **kw),
         "wk": param(gen, (d, nkv * hd), ("d_model", "kv_heads"), **kw),
         "wv": param(gen, (d, nkv * hd), ("d_model", "kv_heads"), **kw),
         "wo": param(gen, (nh * hd, d), ("heads", "d_model"), **kw)}
    if cfg.qkv_bias:
        p["bq"] = param(gen, (nh * hd,), ("heads",), init="zeros", **kw)
        p["bk"] = param(gen, (nkv * hd,), ("kv_heads",), init="zeros", **kw)
        p["bv"] = param(gen, (nkv * hd,), ("kv_heads",), init="zeros", **kw)
    return p


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _qkv(cfg, p, x, xkv=None):
    """q from x (B, S, d); k, v from ``xkv`` (B, T, d), x itself by
    default."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xkv = x if xkv is None else xkv
    B, S = x.shape[:2]
    T = xkv.shape[1]
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, nh, hd)
    k = _proj(xkv, p["wk"], p.get("bk")).reshape(B, T, nkv, hd)
    v = _proj(xkv, p["wv"], p.get("bv")).reshape(B, T, nkv, hd)
    return q, k, v


def _qkv_roped(cfg, p, x, positions, use_rope, xkv, kv_positions):
    """``_qkv`` with RoPE on q at ``positions`` and on k at
    ``kv_positions`` (``positions`` by default) under ``use_rope``: (q, k,
    v, kv_positions), the prelude of both full-sequence attentions."""
    q, k, v = _qkv(cfg, p, x, xkv)
    kv_positions = positions if kv_positions is None else kv_positions
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v, kv_positions


def _grouped_attention(q, k, v, mask):
    """q: (B,S,nh,hd), k/v: (B,T,nkv,hd), mask broadcastable to (B,1,1,S,T).

    Per KV-head group, KV not repeated; scores in f32 from the operands
    (the reference's preferred_element_type=f32), the probabilities cast to
    v's dtype before the product with V, as the reference does."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,kv,g,S,hd)
    kg = k.permute(0, 2, 1, 3).unsqueeze(2)                   # (B,kv,1,T,hd)
    vg = v.permute(0, 2, 1, 3).unsqueeze(2)
    scores = (qg.float() @ kg.float().transpose(-1, -2)) * (hd ** -0.5)
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = w.to(v.dtype) @ vg                                  # (B,kv,g,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nh * hd)


def attend(cfg, p, x, positions, *, causal: bool = True,
           use_rope: bool = True, xkv=None, kv_positions=None,
           impl: str = "auto"):
    """``apply_attention`` up to ``wo``: (the heads' output (B, S, nh·hd),
    (k, v))."""
    q, k, v, _ = _qkv_roped(cfg, p, x, positions, use_rope, xkv,
                            kv_positions)
    if causal and k.shape[1] != q.shape[1]:
        raise ValueError(f"apply_attention: causal over {k.shape[1]} keys "
                         f"for {q.shape[1]} queries; the kernel's causal "
                         "mask is by index")
    B, S = x.shape[:2]
    out = ops.attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        impl=impl)                            # (B,nh,S,hd)
    return out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd), (k, v)


def apply_attention(cfg, p, x, positions, *, causal: bool = True,
                    use_rope: bool = True, xkv=None, kv_positions=None,
                    impl: str = "auto"):
    """Full-sequence attention (prefill, encoder, cross) through
    ``ops.attention``: self-attention over x, or cross-attention of x over
    ``xkv`` (B, T, d) at ``kv_positions`` (``positions`` by default);
    returns (out, (k, v)) with k and v (roped under ``use_rope``) as (B, T,
    nkv, hd).  The causal mask is by index, so causal attention needs T ==
    S and ``positions`` 0 .. S-1 per row (a prefill's); non-causal
    attention masks nothing but the keys past T, at any S and T."""
    out, kv = attend(cfg, p, x, positions, causal=causal, use_rope=use_rope,
                     xkv=xkv, kv_positions=kv_positions, impl=impl)
    return out @ p["wo"].to(out.dtype), kv


def causal_mask(positions_q, positions_k):
    """(B,S),(B,T) -> (B,1,1,S,T) bool."""
    return (positions_q[:, None, None, :, None]
            >= positions_k[:, None, None, None, :])


# Blockwise (flash-style) attention for the train forward: the (S, T) score
# matrix exists only as (S, bk) tiles of a scan over KV chunks, in f32; the
# backward recomputes each tile's probabilities from the saved (out, lse)
# rather than storing them.
_BLOCKWISE_THRESHOLD = 2048  # S·T above which scores must not materialize


def _kv_chunks(k, v, k_pos, bk):
    """K, V (B,T,nkv,hd) padded to a multiple of bk (padded keys at
    position -1) and cut into (nk, B, nkv, bk, hd) f32 chunks; the
    positions into (nk, B, bk)."""
    B, T, nkv, hd = k.shape
    pad_k = (-T) % bk
    nk = (T + pad_k) // bk
    kpos = F.pad(k_pos, (0, pad_k), value=-1)

    def chunks(t):
        t = F.pad(t, (0, 0, 0, 0, 0, pad_k))
        return t.reshape(B, nk, bk, nkv, hd).permute(1, 0, 3, 2, 4).float()
    return chunks(k), chunks(v), kpos.reshape(B, nk, bk).transpose(0, 1), nk


def _tile_mask(q_pos, kpb, causal):
    mask = (kpb >= 0)[:, None, None, None, :]
    if causal:
        mask = mask & (q_pos[:, None, None, :, None]
                       >= kpb[:, None, None, None, :])
    return mask


def _flash_fwd_scan(q, k, v, q_pos, k_pos, causal, bk):
    """q: (B,S,nh,hd); k/v: (B,T,nkv,hd).  Returns the grouped output
    (B,nkv,g,S,hd), f32-normalized then cast to q.dtype, and the f32
    log-sum-exp (B,nkv,g,S)."""
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    bk = min(bk, T)
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4).float()
    kc, vc, kpc, nk = _kv_chunks(k, v, k_pos, bk)
    scale = hd ** -0.5
    m = torch.full((B, nkv, g, S), -1e30, device=q.device)
    l = torch.zeros((B, nkv, g, S), device=q.device)
    acc = torch.zeros((B, nkv, g, S, hd), device=q.device)
    for j in range(nk):
        kb, vb = kc[j].unsqueeze(2), vc[j].unsqueeze(2)     # (B,kv,1,bk,hd)
        s = (qg @ kb.transpose(-1, -2)) * scale
        s = torch.where(_tile_mask(q_pos, kpc[j], causal), s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    lsafe = l.clamp_min(1e-30)
    out = (acc / lsafe[..., None]).to(q.dtype)              # (B,kv,g,S,hd)
    return out, m + torch.log(lsafe)


def _unflatten_out(out, B, S, nh, hd):
    # (B,kv,g,S,hd) -> (B,S,nh*hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nh * hd)


class _BlockwiseAttention(torch.autograd.Function):
    """The reference's ``_blockwise_attention_vjp``: forward saves (q, k, v,
    q_pos, k_pos, out, lse) only; backward is ``_bw_bwd``'s recompute."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, bk):
        out, lse = _flash_fwd_scan(q, k, v, q_pos, k_pos, causal, bk)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.causal, ctx.bk = causal, bk
        B, S, nh, hd = q.shape
        return _unflatten_out(out, B, S, nh, hd)

    @staticmethod
    def backward(ctx, dout):
        """Flash backward: recompute (S, bk) probability tiles per kv chunk
        from the saved (out, lse); dq accumulates across chunks, dk / dv are
        emitted per chunk."""
        q, k, v, q_pos, k_pos, out_g, lse = ctx.saved_tensors
        B, S, nh, hd = q.shape
        T, nkv = k.shape[1], k.shape[2]
        g = nh // nkv
        scale = hd ** -0.5
        bk = min(ctx.bk, T)
        dog = dout.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4).float()
        D = (dog * out_g.float()).sum(-1)                   # (B,kv,g,S)
        qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4).float()
        kc, vc, kpc, nk = _kv_chunks(k, v, k_pos, bk)
        dq = torch.zeros((B, nkv, g, S, hd), device=q.device)
        dks, dvs = [], []
        for j in range(nk):
            kb, vb = kc[j].unsqueeze(2), vc[j].unsqueeze(2)
            s = (qg @ kb.transpose(-1, -2)) * scale
            p = torch.where(_tile_mask(q_pos, kpc[j], ctx.causal),
                            torch.exp(s - lse[..., None]), 0.0)
            dvs.append((p.transpose(-1, -2) @ dog).sum(2))   # (B,kv,bk,hd)
            dp = dog @ vb.transpose(-1, -2)
            ds = p * (dp - D[..., None]) * scale
            dq = dq + ds @ kb
            dks.append((ds.transpose(-1, -2) @ qg).sum(2))
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, nh, hd)

        def unchunk(parts):
            t = torch.stack(parts).permute(1, 0, 3, 2, 4)   # (B,nk,bk,kv,hd)
            return t.reshape(B, nk * bk, nkv, hd)[:, :T]
        return (dq.to(q.dtype), unchunk(dks).to(k.dtype),
                unchunk(dvs).to(v.dtype), None, None, None, None)


def blockwise_attention(q, k, v, q_pos, k_pos, causal, bk: int = 1024):
    """Flash-style attention: (B,S,nh,hd)×(B,T,nkv,hd) -> (B,S,nh*hd),
    O(S·bk) score memory in the forward and the backward."""
    return _BlockwiseAttention.apply(q, k, v, q_pos, k_pos, causal, bk)


def attend_train(cfg, p, x, positions, *, causal: bool = True,
                 use_rope: bool = True, xkv=None, kv_positions=None):
    """``apply_attention_train`` up to ``wo``: (the heads' output (B, S,
    nh·hd), (k, v))."""
    q, k, v, kv_positions = _qkv_roped(cfg, p, x, positions, use_rope, xkv,
                                       kv_positions)
    S, T = q.shape[1], k.shape[1]
    if S * T > _BLOCKWISE_THRESHOLD ** 2:
        out = blockwise_attention(q, k, v, positions, kv_positions, causal)
    else:
        mask = (causal_mask(positions, kv_positions) if causal else
                torch.ones((1, 1, 1, 1, 1), dtype=torch.bool,
                           device=x.device))
        out = _grouped_attention(q, k, v, mask)
    return out, (k, v)


def apply_attention_train(cfg, p, x, positions, *, causal: bool = True,
                          use_rope: bool = True, xkv=None,
                          kv_positions=None):
    """Full-sequence attention of the train forward (self, or cross over
    ``xkv`` at ``kv_positions``), the reference's ``apply_attention``: the
    grouped softmax under a position mask while S·T <=
    ``_BLOCKWISE_THRESHOLD``² (read at call time), else
    ``blockwise_attention``.  Never ``ops.attention``.  Returns (out,
    (k, v))."""
    out, kv = attend_train(cfg, p, x, positions, causal=causal,
                           use_rope=use_rope, xkv=xkv,
                           kv_positions=kv_positions)
    return out @ p["wo"].to(out.dtype), kv


#: The logical axes of a layer's KV cache, the reference's.
KV_CACHE_AXES = {"k": "batch|kv_seq|kv_heads|head_dim",
                 "v": "batch|kv_seq|kv_heads|head_dim"}


def cache_view(c):
    """A layer's cache for a decode step to read and update in place: the
    view itself, or a data row's ``sharding.RowCache`` gathered onto the
    row's device."""
    return c.read() if isinstance(c, shd.RowCache) else c


def cache_commit(c, value, **slot):
    """After a decode step updated ``value`` (``cache_view(c)``) in place:
    nothing for a view; a ``RowCache`` writes it back (``slot``: only the
    ``at`` index along ``dim``)."""
    if isinstance(c, shd.RowCache):
        c.commit(value, **slot)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_attention_decode(cfg, p, x, cache: dict, cur_len, *,
                           use_rope: bool = True):
    """One-token decode: x is (B, 1, d); cache holds k, v (B, T, nkv, hd).

    ``cur_len`` (0-d int32 tensor) is the number of valid positions already
    in the cache; the new token writes at index cur_len, in place, and
    attends over [0, cur_len]."""
    B = x.shape[0]
    pos = cur_len.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _qkv(cfg, p, x)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
    at = cur_len.reshape(1).long()
    k, v = cache["k"], cache["v"]
    k.index_copy_(1, at, k_new.to(k.dtype))
    v.index_copy_(1, at, v_new.to(v.dtype))
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    out = _grouped_attention(q, k, v, kpos <= cur_len)
    return out @ p["wo"].to(out.dtype), cache


def apply_cross_attention_decode(cfg, p, x, cross_k, cross_v):
    """Decode-time cross-attention of x (B, 1, d) over the cached encoder
    K/V (B, T, nkv, hd), unmasked: plain PyTorch, as the reference computes
    it outside any kernel."""
    B = x.shape[0]
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.hd)
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
    out = _grouped_attention(q, cross_k, cross_v, mask)
    return out @ p["wo"].to(out.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen, stack: int = 0, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=_pdt(cfg), stack=stack)
    p = {"wi": param(gen, (d, f), ("d_model", "d_ff"), **kw),
         "wo": param(gen, (f, d), ("d_ff", "d_model"), **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = param(gen, (d, f), ("d_model", "d_ff"), **kw)
    return p


def apply_mlp(cfg, p, x):
    h = x @ p["wi"].to(x.dtype)
    if cfg.act == "swiglu":
        g = x @ p["wg"].to(x.dtype)
        h = F.silu(g.float()).to(x.dtype) * h
    elif cfg.act == "geglu":
        g = x @ p["wg"].to(x.dtype)
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg, gen) -> dict:
    p = {"tok": param(gen, (cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                      dtype=_pdt(cfg), init="embed")}
    if not cfg.tie_embeddings:
        p["out"] = param(gen, (cfg.d_model, cfg.vocab), ("d_model", "vocab"),
                         dtype=_pdt(cfg))
    return p


def embed_tokens(cfg, p, tokens):
    """tokens: int32 (B, S) → (B, S, d) in the activation dtype: rows of the
    table cast to that dtype, as the reference writes it, so a training
    gradient accumulates into the table in the activation dtype as the
    reference's does (the cast is no copy when the table is already in it,
    as serving's is)."""
    dt = dtype_of(cfg.dtype)
    emb = p["tok"].to(dt)[tokens.long()]
    if cfg.tie_embeddings:
        # gemma-style scaled tied embedding; the factor is rounded to the
        # activation dtype first, as the reference's weakly typed scalar is
        emb = emb * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return emb


def logits_out(cfg, p, x):
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["out"].to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def xent_loss(logits, labels, mask=None):
    """Stable cross-entropy; logits (B,S,V) any float dtype, labels int:
    the f32 log-sum-exp minus the gold logit, its mean (or masked mean)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
