"""Parameter init for the port's LM stack: the reference's init law
(repro/models/base.py ``param``) drawn from a ``torch.Generator``.

A parameter tree is a plain dict of tensors with the reference's keys and
shapes, so ``zoo.params_from_numpy`` can carry the JAX tree across leaf by
leaf.  Every leaf is made by ``param`` with the reference's logical axis
names, one per dimension (``"layers"`` for each stacked axis in front);
the tensor carries them as ``LOGICAL_AXES`` and ``axes_of`` reads them
back '|'-joined, as the reference's ``tree_unbox`` encodes them.  An init
run on the ``meta`` device (``gen=None``) gives the shapes and axes of a
tree without allocating it: ``zoo.Model.abstract_params``, from which
``distributed.sharding.tree_shardings`` places parameters and moments on a
mesh.
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


#: Attribute of a parameter tensor holding its logical axes (a tuple).
LOGICAL_AXES = "logical_axes"


def axes_of(t: torch.Tensor) -> str:
    """The '|'-joined logical axes ``param`` gave ``t``."""
    return "|".join(getattr(t, LOGICAL_AXES))


def param(gen: Optional[torch.Generator], shape: Sequence[int],
          axes: Sequence[str], *, dtype: torch.dtype = torch.float32,
          init: str = "normal", scale: Optional[float] = None,
          stack: Union[int, tuple] = 0) -> torch.Tensor:
    """One parameter on ``gen``'s device, with ``axes`` (one logical axis
    name per dim of ``shape``; each stacked axis adds ``"layers"`` in
    front): 'normal' / 'embed' draw N(0, 1) in
    float32 times the scale (default ``init_scale``), 'zeros' and 'ones' are
    constant; then cast to ``dtype``.  ``stack`` > 0 makes that many layers'
    copies on a new leading axis, each drawn in turn into the tensor of
    ``dtype`` (a float32 draw the size of one layer's leaf at a time); the
    scale is still the one layer's.  A tuple ``stack`` gives several
    leading axes, the layers drawn in row-major order (a hybrid's (groups,
    layers a group)); a 0 in it makes a zero-length stack.  ``gen=None``
    gives an empty tensor on the ``meta`` device: the shapes and dtypes of
    a tree without allocating it."""
    assert len(axes) == len(shape), (shape, axes)
    lead = tuple(stack) if isinstance(stack, tuple) else \
        ((stack,) if stack else ())
    out = _draw(gen, shape, lead, dtype, init, scale)
    setattr(out, LOGICAL_AXES, ("layers",) * len(lead) + tuple(axes))
    return out


def _draw(gen, shape, lead, dtype, init, scale) -> torch.Tensor:
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
