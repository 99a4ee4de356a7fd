"""Step builders: the serving entry points — the port of
repro/launch/steps.py's ``build_prefill_step`` and ``build_decode_step``.

Serving runs with bf16 parameters, norm scales included, and activations in
``cfg.dtype`` (the reference's ``lower_cell`` / ``_bf16_init`` rule):
``serving_model`` builds such a model.  The steps run without autograd.
The reference's ``*_specs`` (abstract arguments and mesh shardings) and the
train step wait for multi-GPU sharding and training (ROADMAP A13, A14).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..models import zoo


def serving_model(cfg: ArchConfig, *, serve_dtype: str = "bfloat16",
                  device=None) -> zoo.Model:
    """The model of cfg with every parameter in ``serve_dtype``."""
    return zoo.build(dataclasses.replace(cfg, param_dtype=serve_dtype), device)


def build_prefill_step(model: zoo.Model, max_len: int, *,
                       attn_impl: str = "auto"):
    """(params, batch) -> (cache, last-position logits)."""
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
