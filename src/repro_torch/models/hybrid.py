"""Zamba2-style hybrid: a Mamba-2 backbone and ONE shared attention block —
the port of repro/models/hybrid.py.

Every ``cfg.shared_attn_every`` SSM layers the *same* attention + MLP
block (one weight copy) is applied: Zamba2's parameter sharing.  Each
application keeps its own KV cache (weights shared, state not).

The layer stack has two levels: n_groups groups of ``every`` SSM layers,
each followed by the shared block, then the ``tail`` leftover SSM layers
(81 = 13 × 6 + 3 at full size).  The group leaves are stacked (n_groups,
every, …), the tail's (tail, …), a zero-length stack when the layers
divide evenly, as the reference keeps it.  A prefill runs the shared
block's attention through ``ops.attention`` — the flash kernel on the card
— once an application; a decode attends over that application's cache.
"""
from __future__ import annotations

import torch

from . import layers as L
from . import ssm as S
from . import ssm_lm as SL
from . import transformer as T

#: Families this module computes.
FAMILIES = ("hybrid",)


def group_shape(cfg):
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    tail = cfg.n_layers - n_groups * every
    return n_groups, every, tail


def init(cfg, gen) -> dict:
    """Parameters drawn from ``gen`` in ``cfg.param_dtype``, the group
    layers one at a time in order; ``gen=None`` gives the tree's shapes on
    the ``meta`` device."""
    n_groups, every, tail = group_shape(cfg)
    return {
        "embed": L.init_embed(cfg, gen),
        "groups": SL._block_init(cfg, gen, (n_groups, every)),
        "tail": SL._block_init(cfg, gen, (tail,)),
        "shared": {"ln1": L.init_norm(cfg, gen),
                   "attn": L.init_attention(cfg, gen),
                   "ln2": L.init_norm(cfg, gen),
                   "mlp": L.init_mlp(cfg, gen)},
        "final_norm": L.init_norm(cfg, gen),
    }


def _shared_mlp(cfg, shared, x):
    return x + L.apply_mlp(cfg, shared["mlp"],
                           L.apply_norm(cfg, shared["ln2"], x))


def forward(cfg, params, batch):
    """Causal-LM loss.  batch: tokens (B, S), labels (B, S) [, loss_mask].
    Group layer (g, e) takes its gradient through ``transformer._LayerSlice``
    at index (g, e); the shared block's leaves are used once an application
    and accumulate their gradients across applications."""
    tokens = batch["tokens"].to(torch.int32)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    B, Sq = tokens.shape
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=x.device)[None].expand(B, Sq)
    n_groups, every, tail = group_shape(cfg)
    shared = params["shared"]
    for g in range(n_groups):
        x, _ = T._scan_blocks(cfg, params["groups"], x, None, SL._block,
                              indices=[(g, e) for e in range(every)])
        a, _ = L.apply_attention_train(cfg, shared["attn"],
                                       L.apply_norm(cfg, shared["ln1"], x),
                                       positions, causal=True)
        x = _shared_mlp(cfg, shared, x + a)
    x, _ = T._scan_blocks(cfg, params["tail"], x, None, SL._block,
                          indices=range(tail))
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    loss = L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_axes(cfg) -> dict:
    """The logical axes of ``init_cache``'s tree, the reference's: each
    application's KV on ``apps``."""
    del cfg
    return {"ssm_groups": {k: "apps|layers|" + v
                           for k, v in S.SSM_CACHE_AXES.items()},
            "ssm_tail": {k: "layers|" + v
                         for k, v in S.SSM_CACHE_AXES.items()},
            "kv": {k: "apps|" + v for k, v in L.KV_CACHE_AXES.items()},
            "len": ""}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """{"ssm_groups": conv / state (n_groups, every, B, …), "ssm_tail":
    (tail, B, …), "kv": k / v (n_groups, B, max_len, nkv, hd), "len"}."""
    n_groups, every, tail = group_shape(cfg)
    one = L.init_kv_cache(cfg, batch, max_len, L.dtype_of(cfg.dtype), "meta")
    return {"ssm_groups": SL.stacked_ssm_cache(cfg, (n_groups, every),
                                               batch, device),
            "ssm_tail": SL.stacked_ssm_cache(cfg, (tail,), batch, device),
            "kv": {k: torch.zeros((n_groups,) + v.shape, dtype=v.dtype,
                                  device=device) for k, v in one.items()},
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, max_len: int, *, patch_embs=None,
            attn_impl: str = "auto", cache=None):
    """Run the prompt (B, S) and return (cache, last-position logits (B, 1,
    vocab)), into ``cache`` when given (as ``transformer.prefill``).  The
    shared block attends through ``ops.attention(impl=attn_impl)`` at
    every application, with the same positions.  ``patch_embs`` is
    ignored (no patches)."""
    del patch_embs
    B, Sq = tokens.shape
    if Sq > max_len:
        raise ValueError(f"prefill: {Sq} tokens exceed max_len {max_len}")
    S.check_prompt(cfg, Sq)
    x = L.embed_tokens(cfg, params["embed"], tokens.to(torch.int32))
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=x.device)[None].expand(B, Sq)
    n_groups, every, tail = group_shape(cfg)
    if cache is None:
        cache = init_cache(cfg, B, max_len, x.device)
    shared = params["shared"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for g in range(n_groups):
        for e in range(every):
            x = SL.ssm_prefill(cfg, T.serve_layer(params["groups"], (g, e)),
                               x,
                               SL.layer_cache(cache["ssm_groups"], (g, e)))
        a, (k, v) = L.apply_attention(cfg, shared["attn"],
                                      L.apply_norm(cfg, shared["ln1"], x),
                                      positions, causal=True, impl=attn_impl)
        x = _shared_mlp(cfg, shared, x + a)
        kc[g, :, :Sq] = k
        vc[g, :, :Sq] = v
    for t in range(tail):
        x = SL.ssm_prefill(cfg, T.serve_layer(params["tail"], t), x,
                           SL.layer_cache(cache["ssm_tail"], t))
    h = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], h)
    cache["len"].fill_(Sq)
    return cache, logits


def decode(cfg, params, cache, token):
    """One decode step for token (B, 1): the SSM states, conv windows and
    each application's K/V updated in place (a data row's view of a
    sharded cache read and written back, as ``transformer.decode``);
    returns (cache with len + 1, logits (B, 1, vocab))."""
    cur = cache["len"]
    x = L.embed_tokens(cfg, params["embed"], token.to(torch.int32))
    n_groups, every, tail = group_shape(cfg)
    shared = params["shared"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for g in range(n_groups):
        for e in range(every):
            x = SL.ssm_decode(cfg, T.serve_layer(params["groups"], (g, e)),
                              x, SL.layer_cache(cache["ssm_groups"], (g, e)))
        kg, vg = kc[g], vc[g]
        kv = {"k": L.cache_view(kg), "v": L.cache_view(vg)}
        a, _ = L.apply_attention_decode(cfg, shared["attn"],
                                        L.apply_norm(cfg, shared["ln1"], x),
                                        kv, cur)
        L.cache_commit(kg, kv["k"], dim=1, at=cur)
        L.cache_commit(vg, kv["v"], dim=1, at=cur)
        x = _shared_mlp(cfg, shared, x + a)
    for t in range(tail):
        x = SL.ssm_decode(cfg, T.serve_layer(params["tail"], t), x,
                          SL.layer_cache(cache["ssm_tail"], t))
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    return {"ssm_groups": cache["ssm_groups"], "ssm_tail": cache["ssm_tail"],
            "kv": cache["kv"], "len": cur + 1}, logits
