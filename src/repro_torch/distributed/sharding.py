"""Logical-axis sharding policy, the port's copy of the FlashR half of
repro.distributed.sharding.

Every engine matrix dimension carries a logical axis name ('|'-joined, as
in ``"rows|rep"``).  ``resolve`` maps them to a spec for the active mesh
with divisibility-checked greedy assignment:

* each logical axis has an ordered candidate list of mesh-axis groups;
* a candidate is taken iff every component mesh axis is still unused in
  this tensor's spec and the dim size divides evenly;
* otherwise fall through (ultimately replicate).

The port has no sharded tensor type, so a spec is a plain tuple, one
entry per dimension: ``None`` (replicated), an axis name, or a tuple of
names (sharded over their product) — the counterpart of a
``PartitionSpec``.  Every function here takes any object with
``axis_names`` and a numpy ``devices`` array: a `launch.mesh.Mesh`, or a
stand-in with the same two attributes.

The LM half of the reference — ``sharding_for``, ``tree_shardings``,
``hint`` and ``hint_tree``, which shard model parameters and activations
— comes with the rest of the LM stack (ROADMAP A14); ``RULES`` keeps its
LM axes so ``resolve`` answers as the reference does for them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np

# Ordered candidates per logical axis.  Tuples are axis groups (sharded over
# the product).  First fit wins.
RULES: dict[str, list] = {
    # parameters
    "vocab": [("model",)],
    "d_ff": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "experts": [("model",)],
    "d_inner": [("model",)],
    "d_model": [("data",)],          # FSDP axis (params + optimizer state)
    "layers": [],
    "head_dim": [],
    "state": [],
    "conv": [],
    # activations
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "seq": [],
    "act_seq": [("model",)],
    "embed": [],
    "act_ff": [("model",)],
    "act_heads": [("model",)],
    "act_inner": [("model",)],
    "capacity": [],
    # decode caches: prefer giving spare axes to the KV sequence
    "kv_seq": [("data", "model"), ("model",), ("data",)],
    "apps": [],
    "rep": [],                        # force-replicated
    # Engine matrices: the long (streamed-row) dimension of a materialized
    # output shards over the data tier; sinks and epilogue values use
    # "rep".  Falls through to replicate when the row count does not
    # divide.
    "rows": [("pod", "data"), ("data",)],
}

#: Mesh axes that carry the engine's DATA tier: the partition loop shards
#: its row ranges over the product of these axes; any other axis
#: (``model``) replicates the sweep.
DATA_AXES = ("pod", "data", "x", "i")


def mesh_data_axes(mesh) -> tuple:
    """The mesh's data-tier axis names, in mesh order (never empty: a mesh
    with no recognized data axis falls back to its first axis)."""
    axes = tuple(a for a in mesh.axis_names if a in DATA_AXES)
    return axes or (mesh.axis_names[0],)


def data_axis_size(mesh) -> int:
    """Number of row shards the engine's partition loop splits into."""
    sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    n = 1
    for a in mesh_data_axes(mesh):
        n *= int(sizes[a])
    return n


def shard_devices(mesh) -> list:
    """One device per data shard (index 0 along non-data axes), in
    row-shard order: the devices the sharded partition loop drives its
    per-shard prefetchers and steps on."""
    names = list(mesh.axis_names)
    devs = np.asarray(mesh.devices, dtype=object)
    data_idx = [names.index(a) for a in mesh_data_axes(mesh)]
    other = [i for i in range(devs.ndim) if i not in data_idx]
    devs = np.transpose(devs, data_idx + other).reshape(
        data_axis_size(mesh), -1)
    return list(devs[:, 0])


def resolve(axes: str, shape, mesh) -> tuple:
    """'batch|seq|embed' + shape -> spec tuple for this mesh."""
    names = axes.split("|") if axes else []
    assert len(names) == len(shape), (axes, shape)
    used: set[str] = set()
    spec = []
    mesh_sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    serve = is_serve_mode()
    for name, dim in zip(names, shape):
        placed = None
        rules = RULES.get(name, [])
        if serve and name == "d_model":
            rules = []                 # weights-resident decode (no FSDP)
        for cand in rules:
            cand = tuple(a for a in cand if a in mesh_sizes)
            if not cand or any(a in used for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= mesh_sizes[a]
            if prod > 1 and dim % prod == 0:
                placed = cand
                used.update(cand)
                break
        spec.append(placed[0] if placed and len(placed) == 1
                    else (placed if placed else None))
    return tuple(spec)


# ---------------------------------------------------------------------------
# A thread-local "current mesh" and the serving profile
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield
    finally:
        _TLS.mesh = prev


@contextlib.contextmanager
def serve_mode():
    """Serving sharding profile: parameters replicate over ``data`` instead
    of FSDP-sharding on it (a decode step reads every weight once a
    token, so gathering them each step would dominate)."""
    prev = getattr(_TLS, "serve", False)
    _TLS.serve = True
    try:
        yield
    finally:
        _TLS.serve = prev


def is_serve_mode() -> bool:
    return getattr(_TLS, "serve", False)


def current_mesh() -> Optional[object]:
    return getattr(_TLS, "mesh", None)
