"""Attention-free Mamba-2 LM (the mamba2-1.3b family) — the port of
repro/models/ssm_lm.py.

Pre-norm residual SSM blocks; the layer leaves stacked on a leading
``n_layers`` axis and run by a plain loop, as ``transformer`` does.  Decode
is O(1) a token (the rolling conv window and the (H, P, N) state), which is
why this family runs the ``long_500k`` cell: the cache does not grow with
``max_len``.
"""
from __future__ import annotations

import torch

from . import layers as L
from . import ssm as S
from . import transformer as T

#: Families this module computes.
FAMILIES = ("ssm",)


def _block_init(cfg, gen, stack) -> dict:
    return {"ln": L.init_norm(cfg, gen, stack),
            "ssm": S.init_ssm(cfg, gen, stack)}


def init(cfg, gen) -> dict:
    """Parameters drawn from ``gen`` in ``cfg.param_dtype``; ``gen=None``
    gives the tree's shapes on the ``meta`` device."""
    return {"embed": L.init_embed(cfg, gen),
            "layers": _block_init(cfg, gen, cfg.n_layers),
            "final_norm": L.init_norm(cfg, gen)}


def _block(cfg, blk, x, positions):
    del positions
    y = S.apply_ssm(cfg, blk["ssm"], L.apply_norm(cfg, blk["ln"], x))[0]
    return x + y, 0.0


def forward(cfg, params, batch):
    """Causal-LM loss.  batch: tokens (B, S), labels (B, S) [, loss_mask]."""
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"].to(torch.int32))
    x, _ = T._scan_blocks(cfg, params["layers"], x, None, _block)
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    loss = L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def stacked_ssm_cache(cfg, lead: tuple, batch: int, device) -> dict:
    """``init_ssm_cache`` with the leading axes ``lead`` (zeros)."""
    one = S.init_ssm_cache(cfg, batch, L.dtype_of(cfg.dtype), "meta")
    return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=device)
            for k, v in one.items()}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """{"ssm": {"conv": (L, B, K - 1, C), "state": (L, B, H, P, N)},
    "len"}; ``max_len`` is ignored: the state is O(1)."""
    del max_len
    return {"ssm": stacked_ssm_cache(cfg, (cfg.n_layers,), batch, device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def ssm_prefill(cfg, blk, x, cache: dict):
    """One SSM block of a prefill: x + the mixer's output, its final state
    and conv window written into ``cache``'s views."""
    y, state, window = S.apply_ssm(cfg, blk["ssm"],
                                   L.apply_norm(cfg, blk["ln"], x))
    cache["conv"].copy_(window)
    cache["state"].copy_(state)
    return x + y


def ssm_decode(cfg, blk, x, cache: dict):
    y, _ = S.apply_ssm_decode(cfg, blk["ssm"],
                              L.apply_norm(cfg, blk["ln"], x), cache)
    return x + y


def layer_cache(cache: dict, i) -> dict:
    """Layer i's views of a stacked SSM cache."""
    return {k: v[i] for k, v in cache.items()}


def prefill(cfg, params, tokens, max_len: int, *, patch_embs=None,
            attn_impl: str = "auto"):
    """Run the prompt (B, S) and return (cache, last-position logits (B, 1,
    vocab)): each layer's final SSM state and the last K - 1 conv inputs.
    ``max_len``, ``patch_embs`` and ``attn_impl`` are ignored (no
    attention, no KV, no patches)."""
    del max_len, patch_embs, attn_impl
    B, Sq = tokens.shape
    S.check_prompt(cfg, Sq)
    x = L.embed_tokens(cfg, params["embed"], tokens.to(torch.int32))
    cache = init_cache(cfg, B, 0, x.device)
    for i in range(cfg.n_layers):
        x = ssm_prefill(cfg, T.layer(params["layers"], i), x,
                        layer_cache(cache["ssm"], i))
    h = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], h)
    cache["len"].fill_(Sq)
    return cache, logits


def decode(cfg, params, cache, token):
    """One decode step for token (B, 1): updates each layer's state and
    conv window in the stacked cache in place and returns (cache with
    len + 1, logits (B, 1, vocab))."""
    x = L.embed_tokens(cfg, params["embed"], token.to(torch.int32))
    for i in range(cfg.n_layers):
        x = ssm_decode(cfg, T.layer(params["layers"], i), x,
                       layer_cache(cache["ssm"], i))
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    return {"ssm": cache["ssm"], "len": cache["len"] + 1}, logits
