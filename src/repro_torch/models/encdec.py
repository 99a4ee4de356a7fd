"""Whisper-style encoder–decoder — the port of repro/models/encdec.py.

The conv/mel frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames`` (B, enc_len, d_model), which the
encoder takes with sinusoidal positions (bidirectional attention, no
RoPE).  The decoder is a causal LM with sinusoidal positions and, in each
layer, cross-attention into the encoder output.

The parameter tree is the reference's: ``embed``, ``enc_layers`` (ln1,
attn, ln2, mlp) and ``dec_layers`` (ln1, self, ln2, cross, ln3, mlp),
stacked on a leading layer axis, ``enc_norm`` and ``dec_norm``.

Serving: ``prefill`` encodes once and runs the decoder over the prompt;
every attention of it — the encoder's self-attention and the decoder's
cross-attention (not causal), the decoder's self-attention (causal, S ==
T) — goes through ``ops.attention``, the flash kernel on the card, so a
prefill launches it n_enc_layers + 2 · n_layers times.  The cache is the
reference's ``{"kv": {"k", "v"}: (L, B, max_len, nkv, hd), "cross_k",
"cross_v": (L, B, enc_len, nkv, hd), "len"}`` in ``cfg.dtype`` (``len`` a
0-d int32); ``decode`` is encoder-free: its self-attention writes the
cache in place, its cross-attention reads the cached encoder K/V, both
plain PyTorch as the reference computes them.

Training (``forward``) takes ``apply_attention_train`` throughout; under
``cfg.remat`` each encoder and decoder block runs under
``torch.utils.checkpoint``, the encoder output an input of every decoder
block's, so its gradient reaches the encoder from every decoder layer.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import transformer as T

#: Families this module computes.
FAMILIES = ("encdec",)


def init(cfg, gen) -> dict:
    """Parameters drawn from ``gen`` in ``cfg.param_dtype``; ``gen=None``
    gives the tree's shapes on the ``meta`` device."""
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": L.init_embed(cfg, gen),
        "enc_layers": {"ln1": L.init_norm(cfg, gen, ne),
                       "attn": L.init_attention(cfg, gen, ne),
                       "ln2": L.init_norm(cfg, gen, ne),
                       "mlp": L.init_mlp(cfg, gen, ne)},
        "enc_norm": L.init_norm(cfg, gen),
        "dec_layers": {"ln1": L.init_norm(cfg, gen, nd),
                       "self": L.init_attention(cfg, gen, nd),
                       "ln2": L.init_norm(cfg, gen, nd),
                       "cross": L.init_attention(cfg, gen, nd),
                       "ln3": L.init_norm(cfg, gen, nd),
                       "mlp": L.init_mlp(cfg, gen, nd)},
        "dec_norm": L.init_norm(cfg, gen),
    }


def _positions(B, n, device):
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(B, n)


def _serve_attention(attn_impl):
    return functools.partial(L.apply_attention, impl=attn_impl)


def _enc_input(cfg, frames):
    """The encoder's input and positions: frames and sinusoids, each
    rounded to ``cfg.dtype`` before the sum, as the reference adds them."""
    B, Tn = frames.shape[:2]
    dt = L.dtype_of(cfg.dtype)
    pos = _positions(B, Tn, frames.device)
    return frames.to(dt) + L.sinusoidal(pos, cfg.d_model).to(dt), pos


def _enc_block(cfg, blk, x, pos, attend=L.apply_attention_train):
    """One encoder block: (x', 0.0), the aux loss of ``_scan_blocks``."""
    a, _ = attend(cfg, blk["attn"], L.apply_norm(cfg, blk["ln1"], x), pos,
                  causal=False, use_rope=False)
    x = x + a
    return x + L.apply_mlp(cfg, blk["mlp"],
                           L.apply_norm(cfg, blk["ln2"], x)), 0.0


def encode(cfg, params, frames, *, attn_impl: str = "auto"):
    """frames (B, enc_len, d_model) -> the normed encoder output, its
    attention through ``ops.attention(impl=attn_impl)``."""
    x, pos = _enc_input(cfg, frames)
    attend = _serve_attention(attn_impl)
    for i in range(cfg.n_enc_layers):
        x, _ = _enc_block(cfg, T.layer(params["enc_layers"], i), x, pos,
                          attend)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_block(cfg, blk, x, pos, enc_out, enc_pos,
               attend=L.apply_attention_train):
    """One decoder block: (x', (k, v) of its self-attention, (k, v) of its
    cross-attention over ``enc_out``)."""
    a, kv = attend(cfg, blk["self"], L.apply_norm(cfg, blk["ln1"], x), pos,
                   causal=True, use_rope=False)
    x = x + a
    # Not causal: the kernel masks only keys past T = enc_len, the
    # reference nothing, so its index mask is exact at S != T.
    c, cross_kv = attend(cfg, blk["cross"], L.apply_norm(cfg, blk["ln2"], x),
                         pos, causal=False, use_rope=False, xkv=enc_out,
                         kv_positions=enc_pos)
    x = x + c
    x = x + L.apply_mlp(cfg, blk["mlp"], L.apply_norm(cfg, blk["ln3"], x))
    return x, kv, cross_kv


def _dec_input(cfg, params, tokens, pos):
    """Token embeddings plus the sinusoids cast to their dtype."""
    x = L.embed_tokens(cfg, params["embed"], tokens.to(torch.int32))
    return x + L.sinusoidal(pos, cfg.d_model).to(x.dtype)


def _dec_train(cfg, blk, x, pos, enc_out, enc_pos):
    return _dec_block(cfg, blk, x, pos, enc_out, enc_pos)[0]


def forward(cfg, params, batch):
    """The decoder's LM loss.  batch: frames (B, enc_len, d), tokens (B, S),
    labels (B, S)."""
    x, epos = _enc_input(cfg, batch["frames"])
    x, _ = T._scan_blocks(cfg, params["enc_layers"], x, epos, _enc_block,
                          indices=range(cfg.n_enc_layers))
    enc_out = L.apply_norm(cfg, params["enc_norm"], x)
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = _positions(B, S, enc_out.device)
    x = _dec_input(cfg, params, tokens, pos)
    body = functools.partial(_dec_train, cfg)
    for i in range(cfg.n_layers):
        blk = T.train_layer(params["dec_layers"], i)
        if cfg.remat:
            x = checkpoint(body, blk, x, pos, enc_out, epos,
                           use_reentrant=False)
        else:
            x = body(blk, x, pos, enc_out, epos)
    h = L.apply_norm(cfg, params["dec_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    loss = L.xent_loss(logits, batch["labels"])
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    dt = L.dtype_of(cfg.dtype)
    one = L.init_kv_cache(cfg, batch, max_len, dt, "meta")
    cross = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
    return {"kv": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                  device=device) for k, v in one.items()},
            "cross_k": torch.zeros(cross, dtype=dt, device=device),
            "cross_v": torch.zeros(cross, dtype=dt, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, frames, tokens, max_len: int, *,
            attn_impl: str = "auto"):
    """Encode ``frames`` (B, enc_len, d), run the prompt (B, S) and return
    (cache, last-position logits (B, 1, vocab))."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    if frames.shape[1] != cfg.enc_len:
        raise ValueError(f"prefill: {frames.shape[1]} frames, the config's "
                         f"enc_len is {cfg.enc_len}")
    enc_out = encode(cfg, params, frames, attn_impl=attn_impl)
    pos = _positions(B, S, enc_out.device)
    enc_pos = _positions(B, cfg.enc_len, enc_out.device)
    x = _dec_input(cfg, params, tokens, pos)
    cache = init_cache(cfg, B, max_len, x.device)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    attend = _serve_attention(attn_impl)
    for i in range(cfg.n_layers):
        x, (k, v), (ck, cv) = _dec_block(
            cfg, T.layer(params["dec_layers"], i), x, pos, enc_out, enc_pos,
            attend)
        kc[i, :, :S] = k
        vc[i, :, :S] = v
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    h = L.apply_norm(cfg, params["dec_norm"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], h)
    cache["len"].fill_(S)
    return cache, logits


def decode(cfg, params, cache, token):
    """One decode step for token (B, 1): its self-attention K/V written
    into the cache in place, cross-attention over the cached encoder K/V;
    returns (cache with len + 1, logits (B, 1, vocab))."""
    cur = cache["len"]
    pos = cur.reshape(1, 1).expand(token.shape[0], 1)
    x = _dec_input(cfg, params, token, pos)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = T.layer(params["dec_layers"], i)
        a, _ = L.apply_attention_decode(cfg, blk["self"],
                                        L.apply_norm(cfg, blk["ln1"], x),
                                        {"k": kc[i], "v": vc[i]}, cur,
                                        use_rope=False)
        x = x + a
        x = x + L.apply_cross_attention_decode(
            cfg, blk["cross"], L.apply_norm(cfg, blk["ln2"], x),
            cache["cross_k"][i], cache["cross_v"][i])
        x = x + L.apply_mlp(cfg, blk["mlp"], L.apply_norm(cfg, blk["ln3"], x))
    h = L.apply_norm(cfg, params["dec_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    return {"kv": cache["kv"], "cross_k": cache["cross_k"],
            "cross_v": cache["cross_v"], "len": cur + 1}, logits
