"""Parameter init for the port's LM stack: the reference's init law
(repro/models/base.py ``param``) drawn from a ``torch.Generator``.

A parameter tree is a plain dict of tensors with the reference's keys and
shapes, so ``zoo.params_from_numpy`` can carry the JAX tree across leaf by
leaf.  The reference's ``Boxed`` leaves and logical axes, and the sharding
hints built on them, are not ported: on one device a hint is the identity
(the engine's sharding policy is ``distributed.sharding``; the LM's
parameter and activation sharding comes with the sharded train step,
ROADMAP A14).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch


def init_scale(shape: Sequence[int], init: str = "normal") -> float:
    """fan_in^-0.5 with fan_in = shape[0] for 2-D and larger weights, the
    last dim for 1-D ones and for ``init="embed"``."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    if init == "embed":
        fan_in = shape[-1]
    return fan_in ** -0.5


def param(gen: Optional[torch.Generator], shape: Sequence[int], *,
          dtype: torch.dtype = torch.float32, init: str = "normal",
          scale: Optional[float] = None,
          stack: Union[int, tuple] = 0) -> torch.Tensor:
    """One parameter on ``gen``'s device: 'normal' / 'embed' draw N(0, 1) in
    float32 times the scale (default ``init_scale``), 'zeros' and 'ones' are
    constant; then cast to ``dtype``.  ``stack`` > 0 makes that many layers'
    copies on a new leading axis, each drawn in turn into the tensor of
    ``dtype`` (a float32 draw the size of one layer's leaf at a time); the
    scale is still the one layer's.  A tuple ``stack`` gives several
    leading axes, the layers drawn in row-major order (a hybrid's (groups,
    layers a group)); a 0 in it makes a zero-length stack.  ``gen=None``
    gives an empty tensor on the ``meta`` device: the shapes and dtypes of
    a tree without allocating it."""
    lead = tuple(stack) if isinstance(stack, tuple) else \
        ((stack,) if stack else ())
    full = lead + tuple(shape)
    if gen is None:
        return torch.empty(full, dtype=dtype, device="meta")
    dev = gen.device
    if init == "zeros":
        return torch.zeros(full, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(full, dtype=dtype, device=dev)
    if scale is None:
        scale = init_scale(shape, init)
    out = torch.empty(full, dtype=dtype, device=dev)
    layers = out.view((math.prod(lead),) + tuple(shape)).unbind(0) \
        if lead else (out,)
    for part in layers:
        part.copy_(torch.randn(tuple(shape), generator=gen,
                               device=dev).mul_(scale))
    return out
