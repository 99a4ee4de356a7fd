"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060) — the port of
repro/models/ssm.py.

Shapes (per layer): d_inner = expand·d_model, P = headdim, H = d_inner / P
heads, N = ssm_state, G = ngroups (B and C shared by the H / G heads of a
group).

    in_proj : d_model -> [z (d_inner), x (d_inner), B (G·N), C (G·N), dt (H)]
    conv1d  : causal depthwise, width K = ssm_conv, over the (x, B, C) channels
    SSD     : y_t = Σ_{s≤t} C_tᵀ (∏_{r=s+1..t} a_r) B_s (dt_s x_s) + D·x_t
    out     : gated RMSNorm(y, z) -> out_proj

``ssd_chunked`` runs the sequence in 128-token chunks, all in f32: within
a chunk the (L, L) decay-weighted score tile, across chunks the (H, P, N)
state, in place of the reference's ``lax.scan`` a Python loop over blocks
of chunks (as many as ``TILE_BYTES`` holds) and, inside a block, the
state's update from chunk to chunk.  The
tile's decay is ``exp(cum_t - cum_s)``, masked in the exponent (``-inf``
above the diagonal) where the reference masks the product: every kept
entry is the reference's bit for bit, and no ``inf`` is formed for s > t,
where the reference's exponent passes float32's range once a chunk's
summed dt·exp(A_log) passes ~88.7 (its forward still selects 0 there, its
gradient is NaN; ROADMAP §C).

Decode is the O(1) recurrence: S <- a·S + dt·(B ⊗ x), y = C·S + D·x, with
a rolling window of the last K - 1 pre-activation conv inputs.  No TPU
kernel is involved: the reference computes all of it in jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import param
from .layers import dtype_of

CHUNK = 128  # SSD chunk length (the sequence-tier partition)
#: Most bytes of one block of chunks' f32 decay tile, (B, k, H, L, L):
#: ``ssd_chunked`` runs k chunks at once.
TILE_BYTES = 1 << 28


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    return d_in, H, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups


def init_ssm(cfg, gen, stack=0) -> dict:
    """The reference's init law: in_proj and out_proj N(0, fan_in^-1),
    conv_w N(0, 1)·ssm_conv^-0.5, conv_b, A_log and dt_bias zeros, D and
    the gated norm's scale ones."""
    d = cfg.d_model
    d_in, H, P, N, G = dims(cfg)
    conv_ch = d_in + 2 * G * N
    kw = dict(dtype=dtype_of(cfg.param_dtype), stack=stack)
    return {
        "in_proj": param(gen, (d, 2 * d_in + 2 * G * N + H), **kw),
        "conv_w": param(gen, (cfg.ssm_conv, conv_ch),
                        scale=cfg.ssm_conv ** -0.5, **kw),
        "conv_b": param(gen, (conv_ch,), init="zeros", **kw),
        "A_log": param(gen, (H,), init="zeros", **kw),
        "dt_bias": param(gen, (H,), init="zeros", **kw),
        "D": param(gen, (H,), init="ones", **kw),
        "norm": param(gen, (d_in,), init="ones", **kw),
        "out_proj": param(gen, (d_in, d), **kw),
    }


def _split(cfg, zxbcdt):
    d_in, H, P, N, G = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def _gated_norm(cfg, w, y, z):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.rms_eps) * w.float()).to(y.dtype)


def _conv_sum(window, w):
    """Σ_i window[:, i] · w[i] over the K taps, in order, in the activation
    dtype: the reference's prefill sum, which decode repeats on its window
    so that a bf16 prefill and a bf16 decode step add alike."""
    return sum(window[:, i] * w[i] for i in range(w.shape[0]))


def _conv_full(x, w, b):
    """Causal depthwise conv over (B, S, C) with width-K taps (K, C): K
    shifted products summed in order in x's dtype (not ``F.conv1d``, whose
    order and cuDNN path differ), then SiLU in f32."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu((out + b).float()).to(x.dtype)


def ssd_chunked(xh, dt, a_log, Bc, Cc, chunk: int = CHUNK, init_state=None):
    """Chunked SSD.  xh (B, S, H, P), dt (B, S, H) positive, a =
    exp(-dt·exp(a_log)), Bc / Cc (B, S, G, N); S a multiple of ``chunk``.
    Returns (y (B, S, H, P) f32, final state (B, H, P, N) f32).

    The chunks run a block at a time, as many as keep the block's (B, k,
    H, L, L) f32 decay tile within ``TILE_BYTES``: each chunk's intra-chunk
    term, its own contribution to the state at its end and its total decay
    are computed for the whole block at once; the state entering each
    chunk is then carried through the block chunk by chunk, with the
    reference's update S <- S·decay(chunk) + contribution, and each chunk's
    inter-chunk term read from it.  The (L, L) tiles never exist for more
    than one block.  B and C enter every product per group, broadcast over
    the group's heads (the reference repeats them per head first: the same
    products)."""
    Bsz, S, H, P = xh.shape
    G, N = Bc.shape[2], Bc.shape[3]
    rep = H // G
    nc = S // chunk
    f32 = torch.float32

    loga = -dt.to(f32) * torch.exp(a_log.to(f32))[None, None, :]
    xw = xh.to(f32) * dt[..., None].to(f32)              # dt-weighted input
    Bf, Cf = Bc.to(f32), Cc.to(f32)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    ids = torch.arange(chunk, device=xh.device)
    causal = ids[:, None] >= ids[None, :]                # (L, L)
    neg_inf = torch.tensor(-float("inf"), dtype=f32, device=xh.device)
    per_chunk = Bsz * H * chunk * chunk * 4
    k = max(1, min(nc, TILE_BYTES // per_chunk))
    ys = []
    for c0 in range(0, nc, k):
        kc = min(k, nc - c0)
        sl = slice(c0 * chunk, (c0 + kc) * chunk)

        def blk(t):
            # (B, kc·L, ...) -> (B, kc, L, ...)
            return t[:, sl].reshape((Bsz, kc, chunk) + t.shape[2:])
        x_c, B_c, C_c = blk(xw), blk(Bf), blk(Cf)
        cum = torch.cumsum(blk(loga), dim=2)             # (B, k, L, H)

        # Intra-chunk: y_t += C_t·B_s decay(s -> t) x_s, s <= t
        scores = torch.einsum("bclgn,bcmgn->bcglm", C_c, B_c)  # (B,k,G,L,L)
        cum_t = cum.transpose(2, 3)                      # (B, k, H, L)
        decay = torch.exp(torch.where(
            causal, cum_t[..., :, None] - cum_t[..., None, :], neg_inf))
        att = (scores[:, :, :, None]
               * decay.reshape(Bsz, kc, G, rep, chunk, chunk)
               ).reshape(Bsz, kc, H, chunk, chunk)
        y = torch.einsum("bchlm,bcmhp->bclhp", att, x_c)

        # Each chunk's contribution to the state at its end, and its decay
        dec_end = torch.exp(cum[:, :, -1:] - cum)        # (B, k, L, H)
        xe = (x_c * dec_end[..., None]).reshape(Bsz, kc, chunk, G, rep, P)
        contrib = torch.einsum("bclgn,bclgrp->bcgrpn", B_c, xe).reshape(
            Bsz, kc, H, P, N)
        total = torch.exp(cum[:, :, -1])                 # (B, k, H)
        entering = []
        for j in range(kc):
            entering.append(state)
            state = state * total[:, j, :, None, None] + contrib[:, j]

        # Inter-chunk: y_t += C_t decay(start -> t) S_entering
        s_in = torch.stack(entering, 1).reshape(Bsz, kc, G, rep, P, N)
        y_in = torch.einsum("bclgn,bcgrpn->bclgrp", C_c, s_in).reshape(
            Bsz, kc, chunk, H, P)
        y = y + y_in * torch.exp(cum)[..., None]
        ys.append(y.reshape(Bsz, kc * chunk, H, P))
    return torch.cat(ys, dim=1), state


def xh_bc(t, G, N):
    return t.reshape(t.shape[0], t.shape[1], G, N)


def check_prompt(cfg, S: int):
    """A prefill's conv window is its last K - 1 inputs: a shorter prompt
    has none to give (the reference does not handle it either)."""
    if S < cfg.ssm_conv - 1:
        raise ValueError(f"prefill: a prompt of {S} tokens is shorter than "
                         f"the conv window's {cfg.ssm_conv - 1}")


def apply_ssm(cfg, p, x, *, init_state=None):
    """Full-sequence Mamba-2 mixer.  x: (B, S, d) -> (out (B, S, d), final
    state (B, H, P, N) f32, conv window (B, K - 1, C): the last K - 1
    pre-activation conv inputs in ``cfg.dtype``, decode's rolling window).

    A ragged S is zero-padded to a multiple of ``CHUNK`` after softplus, as
    the reference pads: a pad step has dt = 0, which leaves the state as it
    was."""
    d_in, H, P, N, G = dims(cfg)
    B_, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xr, Bc, Cc, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xr, Bc, Cc], dim=-1)
    window = conv_in[:, -(cfg.ssm_conv - 1):].to(dtype_of(cfg.dtype))
    conv_out = _conv_full(conv_in, p["conv_w"].to(x.dtype),
                          p["conv_b"].to(x.dtype))
    xr, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())

    pad = (-S) % CHUNK
    if pad:
        def padf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xr_, dtp_, Bc_, Cc_ = padf(xr), padf(dtp), padf(Bc), padf(Cc)
    else:
        xr_, dtp_, Bc_, Cc_ = xr, dtp, Bc, Cc

    xh = xr_.reshape(B_, -1, H, P)
    y, state = ssd_chunked(xh, dtp_, p["A_log"], xh_bc(Bc_, G, N),
                           xh_bc(Cc_, G, N), init_state=init_state)
    y = y[:, :S]
    y = y + xr.reshape(B_, S, H, P) * p["D"].float()[None, None, :, None]
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = _gated_norm(cfg, p["norm"], y, z)
    return y @ p["out_proj"].to(x.dtype), state, window


# ---------------------------------------------------------------------------
# Decode (O(1) state recurrence)
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    """{"conv": (B, K - 1, C) in ``dtype``, "state": (B, H, P, N) f32}."""
    d_in, H, P, N, G = dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                                 device=device)}


def apply_ssm_decode(cfg, p, x, cache: dict):
    """One-token step.  x: (B, 1, d); cache {"conv", "state"} as
    ``init_ssm_cache`` (views into a stacked cache are fine).  Writes the
    rolled window and the new state into the cache tensors in place and
    returns (out (B, 1, d), cache)."""
    d_in, H, P, N, G = dims(cfg)
    B_ = x.shape[0]
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xr, Bc, Cc, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xr, Bc, Cc], dim=-1)               # (B, 1, C)
    window = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)  # (B, K, C)
    conv_out = (_conv_sum(window, p["conv_w"].to(x.dtype))
                + p["conv_b"].to(x.dtype))[:, None]
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xr, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)

    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"].float())     # (B, H)
    a = torch.exp(-dtp * torch.exp(p["A_log"].float()))           # (B, H)
    xh = xr.reshape(B_, H, P).float() * dtp[..., None]
    Bh = Bc.reshape(B_, G, N).repeat_interleave(H // G, dim=1).float()
    Ch = Cc.reshape(B_, G, N).repeat_interleave(H // G, dim=1).float()

    state = cache["state"] * a[:, :, None, None] \
        + xh[..., :, None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + xr.reshape(B_, H, P).float() * p["D"].float()[None, :, None]
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = _gated_norm(cfg, p["norm"], y, z)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return y @ p["out_proj"].to(x.dtype), cache
