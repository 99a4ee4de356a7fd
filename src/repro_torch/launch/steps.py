"""Step functions: the train, prefill and decode entry points — the port of
repro/launch/steps.py's ``build_train_step``, ``build_prefill_step`` and
``build_decode_step``.

Training keeps f32 masters and computes in ``cfg.dtype``; the step takes
(params, opt_state, batch) and returns (params', opt_state', metrics) with
the parameters and moments updated in place (the reference's jitted step
donates them).  Serving runs with bf16 parameters, norm scales included,
and activations in ``cfg.dtype`` (the reference's ``lower_cell`` /
``_bf16_init`` rule): ``serving_model`` builds such a model; the serving
steps run without autograd.  Every ported family (dense, MoE, VLM, SSM,
hybrid, enc-dec) takes the same steps; a VLM's batch carries ``patch_embs``
(B, n_patches, d_model) beside its tokens, an enc-dec's ``frames`` (B,
enc_len, d_model).  The reference's ``*_specs`` (abstract
arguments and mesh shardings of the LM stack) wait for the sharded train
step (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..models import zoo
from ..optim import adam


def loss_and_grads(model: zoo.Model, params: dict, batch: dict):
    """(loss, metrics, grads) of one step's batch.  ``cfg.grad_accum`` > 1
    splits the batch into that many microbatches, in order, and runs one
    backward each: the gradients add up in each leaf's ``.grad`` (f32 for
    f32 masters, as the reference's ``g_acc``; the parameter dtype
    otherwise), then are divided by the count, and the loss is the mean of
    the microbatches' losses.  ``grads`` are the leaves' ``.grad``
    tensors, in the parameters' tree.  A zero-length leaf (a hybrid's
    empty tail), which no loss reads, gets its empty gradient, as jax.grad
    gives; any other leaf the loss did not reach raises."""
    accum = max(1, model.cfg.grad_accum)
    for _, p in zoo.flatten(params):
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p) if p.numel() == 0 else None
    if accum == 1:
        loss, metrics = model.forward(params, batch)
        loss.backward()
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
    else:
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        loss_sum = 0.0
        for i in range(accum):
            l, _ = model.forward(params, {k: v[i] for k, v in micro.items()})
            l.backward()
            loss_sum = loss_sum + l.detach()
        loss = loss_sum / accum
        metrics = {"loss": loss}
    missing = [name for name, p in zoo.flatten(params) if p.grad is None]
    if missing:
        raise RuntimeError(f"the loss reached no gradient of {missing}")
    if accum > 1:
        with torch.no_grad():
            for _, p in zoo.flatten(params):
                p.grad.div_(accum)
    grads = zoo.tree_map(lambda _, p: p.grad, params)
    return loss, metrics, grads


def build_train_step(model: zoo.Model,
                     opt_cfg: adam.AdamConfig = adam.AdamConfig()):
    """(params, opt_state, batch) -> (params', opt_state', metrics), metrics
    ``loss`` and ``grad_norm``: ``loss_and_grads`` then ``adam.update``,
    which writes the parameters and moments in place; the gradients are
    released after the update."""
    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(model, params, batch)
        new_params, new_opt, opt_metrics = adam.update(
            grads, opt_state, params, opt_cfg)
        del grads
        for _, p in zoo.flatten(params):
            p.grad = None
        return new_params, new_opt, dict(metrics, **opt_metrics)
    return train_step


def serving_model(cfg: ArchConfig, *, serve_dtype: str = "bfloat16",
                  device=None) -> zoo.Model:
    """The model of cfg with every parameter in ``serve_dtype``."""
    return zoo.build(dataclasses.replace(cfg, param_dtype=serve_dtype), device)


def build_prefill_step(model: zoo.Model, max_len: int, *,
                       attn_impl: str = "auto"):
    """(params, batch) -> (cache, last-position logits); batch: tokens
    (B, S) [, patch_embs (B, P, d) | frames (B, enc_len, d)]."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, max_len, attn_impl=attn_impl)
    return prefill_step


def build_decode_step(model: zoo.Model):
    """(params, cache, token) -> (cache, logits)."""
    def decode_step(params, cache, token):
        with torch.no_grad():
            return model.decode(params, cache, token)
    return decode_step
