"""Decoder-only LM, dense family: init, KV cache, prefill and decode — the
port of repro/models/transformer.py's serving entry points.

The parameter tree is the reference's: layer leaves stacked on a leading
``n_layers`` axis; a plain loop over the layers (views into the stacked
tensors) stands in for ``lax.scan``.  The cache is the reference's
``{"kv": {"k", "v"}: (L, B, max_len, nkv, hd), "len"}``, ``len`` a 0-d
int32 tensor on the model's device.  Training (``forward`` / the loss) and
the MoE and VLM variants wait for ROADMAP A14.
"""
from __future__ import annotations

import torch

from . import layers as L


def _block_init(cfg, gen, stack: int) -> dict:
    if cfg.n_experts:
        raise NotImplementedError("MoE layers: ROADMAP A14")
    return {"ln1": L.init_norm(cfg, gen, stack),
            "attn": L.init_attention(cfg, gen, stack),
            "ln2": L.init_norm(cfg, gen, stack),
            "mlp": L.init_mlp(cfg, gen, stack)}


def init(cfg, gen) -> dict:
    """Parameters drawn from ``gen`` (a ``torch.Generator`` on the device
    they go to) in ``cfg.param_dtype``; ``gen=None`` gives the tree's shapes
    on the ``meta`` device."""
    return {"embed": L.init_embed(cfg, gen),
            "layers": _block_init(cfg, gen, cfg.n_layers),
            "final_norm": L.init_norm(cfg, gen)}


def layer(stacked: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    one = L.init_kv_cache(cfg, batch, max_len, L.dtype_of(cfg.dtype), "meta")
    return {"kv": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                  device=device) for k, v in one.items()},
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, max_len: int, *, attn_impl: str = "auto"):
    """Run the prompt (B, S) and return (cache, last-position logits
    (B, 1, vocab))."""
    tokens = tokens.to(torch.int32)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_len, x.device)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = layer(params["layers"], i)
        h = L.apply_norm(cfg, blk["ln1"], x)
        a, (k, v) = L.apply_attention(cfg, blk["attn"], h, positions,
                                      causal=True, impl=attn_impl)
        x = x + a
        h = L.apply_norm(cfg, blk["ln2"], x)
        x = x + L.apply_mlp(cfg, blk["mlp"], h)
        kc[i, :, :S] = k
        vc[i, :, :S] = v
    h = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], h)
    cache["len"].fill_(S)
    return cache, logits


def decode(cfg, params, cache, token):
    """One decode step for token (B, 1): writes the token's K/V into the
    cache tensors in place and returns (cache with len + 1, logits
    (B, 1, vocab))."""
    x = L.embed_tokens(cfg, params["embed"], token.to(torch.int32))
    cur = cache["len"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = layer(params["layers"], i)
        h = L.apply_norm(cfg, blk["ln1"], x)
        a, _ = L.apply_attention_decode(cfg, blk["attn"], h,
                                        {"k": kc[i], "v": vc[i]}, cur)
        x = x + a
        h = L.apply_norm(cfg, blk["ln2"], x)
        x = x + L.apply_mlp(cfg, blk["mlp"], h)
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    return {"kv": cache["kv"], "len": cur + 1}, logits
