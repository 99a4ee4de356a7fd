"""Decoder-only LM — the dense, MoE and VLM families: init, the train
forward, KV cache, prefill and decode — the port of
repro/models/transformer.py.

The parameter tree is the reference's: layer leaves stacked on a leading
``n_layers`` axis; a plain loop over the layers (views into the stacked
tensors) stands in for ``lax.scan``.  The cache is the reference's
``{"kv": {"k", "v"}: (L, B, max_len, nkv, hd), "len"}``, ``len`` a 0-d
int32 tensor on the model's device.

``forward(cfg, params, batch) -> (loss, {"loss": loss})`` is the causal-LM
loss.  With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the block's
input, as the reference's ``jax.checkpoint(nothing_saveable)`` does.

The MoE family (``cfg.n_experts``) puts ``moe.apply_moe`` where the dense
block has its MLP; its train loss adds 0.01 · (the layers' summed
load-balancing loss) / n_layers.  The VLM family (paligemma) takes
``patch_embs`` (B, n_patches, d_model): the image patches' embeddings,
placed before the text's, and the train loss is over the text span only.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as shd
from . import layers as L
from . import moe as M

#: Families this module computes.
FAMILIES = ("dense", "moe", "vlm")


def _block_init(cfg, gen, stack: int) -> dict:
    blk = {"ln1": L.init_norm(cfg, gen, stack),
           "attn": L.init_attention(cfg, gen, stack),
           "ln2": L.init_norm(cfg, gen, stack)}
    if cfg.n_experts:
        blk["moe"] = M.init_moe(cfg, gen, stack)
    else:
        blk["mlp"] = L.init_mlp(cfg, gen, stack)
    return blk


def _ffn(cfg, blk, h, stats=False):
    """The block's second half: (the MoE layer or the MLP of h, aux), aux
    the MoE's load-balancing loss — its ``moe.Balance`` under ``stats``."""
    if cfg.n_experts:
        return M.apply_moe(cfg, blk["moe"], h, stats=stats)
    return L.apply_mlp(cfg, blk["mlp"], h), 0.0


def init(cfg, gen) -> dict:
    """Parameters drawn from ``gen`` (a ``torch.Generator`` on the device
    they go to) in ``cfg.param_dtype``; ``gen=None`` gives the tree's shapes
    on the ``meta`` device."""
    return {"embed": L.init_embed(cfg, gen),
            "layers": _block_init(cfg, gen, cfg.n_layers),
            "final_norm": L.init_norm(cfg, gen)}


def layer(stacked: dict, i) -> dict:
    """Layer i's parameters (i an int, or a tuple over several stacked
    axes): views into the stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def serve_layer(stacked: dict, i) -> dict:
    """Layer i's parameters for a serving step: ``layer``'s views, or under
    a mesh the layer gathered onto the data row's device from its
    ``sharding.RowLeaf`` leaves (``hint_tree``)."""
    return shd.hint_tree(layer(stacked, i))


class _LayerSlice(torch.autograd.Function):
    """Layer i of a stacked leaf, whose gradient is added into slice i of
    the leaf's ``.grad`` (zeros at first use, the leaf's dtype).

    ``leaf[i]`` would do the same through autograd, but ``select``'s
    backward makes a zero tensor the size of the whole stacked leaf for
    every layer: at llama3.2-3b, 11.3 GB of f32 written and added per
    layer and backward.  Here each layer's gradient touches its own slice
    only; across backward calls it accumulates in ``.grad`` as autograd's
    does.

    The leaf's AccumulateGrad node gets no gradient, so its hooks (a
    gradient reducer's among them) see none: read ``.grad`` after
    ``backward()``.  A backward that would not accumulate into the leaf —
    ``torch.autograd.grad``, or ``backward(inputs=...)`` without it —
    raises rather than write ``.grad`` behind its back."""

    @staticmethod
    def forward(ctx, leaf, i, acc):
        ctx.leaf, ctx.i, ctx.acc = leaf, i, acc
        return leaf[i]

    @staticmethod
    def backward(ctx, grad):
        try:
            accumulates = torch._C._will_engine_execute_node(ctx.acc)
        except RuntimeError:  # raised under torch.autograd.grad
            accumulates = False
        if not accumulates:
            raise RuntimeError(
                "a stacked layer leaf takes its gradient in .grad only: "
                "call loss.backward() (with the leaf among its inputs), "
                "not torch.autograd.grad")
        leaf = ctx.leaf
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        leaf.grad[ctx.i] += grad
        return None, None, None


def _slice(leaf, i):
    if not torch.is_grad_enabled():
        return leaf[i]
    # The leaf's AccumulateGrad node, reached through a view's graph.
    acc = leaf.view_as(leaf).grad_fn.next_functions[0][0]
    return _LayerSlice.apply(leaf, i, acc)


def train_layer(stacked: dict, i: int) -> dict:
    """Layer i's parameters for the train forward: views of the stacked
    leaves, a leaf that requires grad through `_LayerSlice`.  Under a mesh
    the leaves are a data row's ``sharding.RowLeaf``: layer i is gathered
    from the shards onto the row's device (``sharding.hint_tree``) and its
    gradient goes into the row's gradient of each position's block."""
    return shd.hint_tree({
        k: train_layer(v, i) if isinstance(v, dict) else
        v[i] if isinstance(v, shd.RowLeaf) else
        _slice(v, i) if v.requires_grad else v[i]
        for k, v in stacked.items()})


def _sharded(tree) -> bool:
    return any(_sharded(v) if isinstance(v, dict) else
               isinstance(v, shd.RowLeaf) for v in tree.values())


def run_block(cfg, body, stacked, i, *args):
    """``body(layer i's parameters, *args)``, under ``cfg.remat`` inside
    ``torch.utils.checkpoint`` (non-reentrant).  A sharded stack gathers
    the layer inside the checkpoint, so the backward gathers it again
    instead of keeping every layer's gathered copy alive (a checkpoint
    keeps its inputs)."""
    if not cfg.remat:
        return body(train_layer(stacked, i), *args)
    if _sharded(stacked):
        return checkpoint(lambda *a: body(train_layer(stacked, i), *a),
                          *args, use_reentrant=False)
    return checkpoint(body, train_layer(stacked, i), *args,
                      use_reentrant=False)


# ---------------------------------------------------------------------------
# Train / full forward
# ---------------------------------------------------------------------------

def _block_apply(cfg, blk, x, positions):
    a, _ = L.apply_attention_train(cfg, blk["attn"],
                                   L.apply_norm(cfg, blk["ln1"], x),
                                   positions, causal=True)
    x = x + a
    m, aux = _ffn(cfg, blk, L.apply_norm(cfg, blk["ln2"], x), stats=True)
    return x + m, aux


def _scan_blocks(cfg, stacked, x, positions, block_fn, indices=None):
    """The layers in order (``indices`` of the stacked leaves, every one of
    the ``n_layers`` by default; an index may be a tuple), each on views of
    its slice of the stacked leaves (``run_block``); under ``cfg.remat``
    each block is recomputed in the backward from its input.  A block's
    aux may be a MoE layer's ``moe.Balance``: its loss is taken here, with
    the batch's first-choice shares under a mesh (``sharding.Row.gather_sum``
    over the data rows)."""
    body = functools.partial(block_fn, cfg)
    row = shd.row_of(stacked)
    aux = 0.0
    for i in (range(cfg.n_layers) if indices is None else indices):
        x, a = run_block(cfg, body, stacked, i, x, positions)
        if isinstance(a, M.Balance):
            pe = None if row is None else \
                row.gather_sum(a.pe * a.n) / row.gather_sum(a.n)
            a = M.balance_loss(a, pe)
        aux = aux + a
    return x, aux


def _embed(cfg, params, tokens, patch_embs):
    """Token embeddings, after the patch embeddings when given."""
    x = L.embed_tokens(cfg, params["embed"], tokens.to(torch.int32))
    if patch_embs is not None:
        x = torch.cat([patch_embs.to(x.dtype), x], dim=1)
    return x


def hidden_states(cfg, params, tokens, *, patch_embs=None):
    """(Patch and) token embedding -> the blocks -> final-norm hidden
    states, and the blocks' summed auxiliary loss (0 but for MoE)."""
    x = _embed(cfg, params, tokens, patch_embs)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x, aux = _scan_blocks(cfg, params["layers"], x, positions, _block_apply)
    return L.apply_norm(cfg, params["final_norm"], x), aux


def forward(cfg, params, batch, *, terms: bool = False):
    """Causal-LM loss.  batch: tokens (B,S), labels (B,S) [, loss_mask]
    [, patch_embs (B, P, d)].  With ``terms`` a MoE returns its loss's two
    terms apart, (the cross-entropy, 0.01 · aux / n_layers), in place of
    (loss, metrics): the sharded step weighs them apart
    (``launch.steps.row_grads``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"transformer.forward trains the {', '.join(FAMILIES)} families, "
            f"not {cfg.family}: zoo.module_for gives each family's module")
    patch = batch.get("patch_embs")
    h, aux = hidden_states(cfg, params, batch["tokens"], patch_embs=patch)
    if patch is not None:
        h = h[:, patch.shape[1]:]            # the text span only (VLM)
    logits = L.logits_out(cfg, params["embed"], h)
    loss = L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))
    if cfg.n_experts:
        if terms:
            return loss, 0.01 * aux / cfg.n_layers
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"loss": loss}


def cache_axes(cfg) -> dict:
    """The logical axes of ``init_cache``'s tree, the reference's."""
    del cfg
    return {"kv": {k: "layers|" + v for k, v in L.KV_CACHE_AXES.items()},
            "len": ""}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    one = L.init_kv_cache(cfg, batch, max_len, L.dtype_of(cfg.dtype), "meta")
    return {"kv": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                                  device=device) for k, v in one.items()},
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, max_len: int, *, patch_embs=None,
            attn_impl: str = "auto", cache=None):
    """Run the prompt — the patch embeddings (B, P, d) when given, then the
    tokens (B, S) — and return (cache, last-position logits (B, 1,
    vocab)); the cache holds P + S positions.  ``cache`` is the cache to
    fill (zeros of ``init_cache``'s tree, or a data row's view of a
    sharded one: ``sharding.bind_cache``); a new one by default."""
    x = _embed(cfg, params, tokens, patch_embs)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill: {S} tokens exceed max_len {max_len}")
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cache is None:
        cache = init_cache(cfg, B, max_len, x.device)
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = serve_layer(params["layers"], i)
        h = L.apply_norm(cfg, blk["ln1"], x)
        a, (k, v) = L.apply_attention(cfg, blk["attn"], h, positions,
                                      causal=True, impl=attn_impl)
        x = x + a
        x = x + _ffn(cfg, blk, L.apply_norm(cfg, blk["ln2"], x))[0]
        kc[i, :, :S] = k
        vc[i, :, :S] = v
    h = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], h)
    cache["len"].fill_(S)
    return cache, logits


def decode(cfg, params, cache, token):
    """One decode step for token (B, 1): writes the token's K/V into the
    cache tensors in place and returns (cache with len + 1, logits
    (B, 1, vocab)).  A data row's view of a sharded cache
    (``sharding.bind_cache``) reads each layer's cache and writes the
    token's K/V back (``layers.cache_view`` / ``cache_commit``)."""
    x = L.embed_tokens(cfg, params["embed"], token.to(torch.int32))
    cur = cache["len"]
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        blk = serve_layer(params["layers"], i)
        h = L.apply_norm(cfg, blk["ln1"], x)
        ki, vi = kc[i], vc[i]
        kv = {"k": L.cache_view(ki), "v": L.cache_view(vi)}
        a, _ = L.apply_attention_decode(cfg, blk["attn"], h, kv, cur)
        L.cache_commit(ki, kv["k"], dim=1, at=cur)
        L.cache_commit(vi, kv["v"], dim=1, at=cur)
        x = x + a
        x = x + _ffn(cfg, blk, L.apply_norm(cfg, blk["ln2"], x))[0]
    h = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.logits_out(cfg, params["embed"], h)
    return {"kv": cache["kv"], "len": cur + 1}, logits
