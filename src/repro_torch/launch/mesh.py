"""Device meshes for the engine's sharded execution (the port's
counterpart of repro.launch.mesh).

A `Mesh` is a numpy object array of ``torch.device`` plus one axis name
per array dimension — what ``distributed.sharding`` and the sharded
partition loop read.  A device may repeat, as in a ``jax.sharding.Mesh``
built from an array: ``Mesh([torch.device("cpu")] * 4, ("data",))`` runs
four shards on the CPU, and ``Mesh([torch.device("cuda", 0)] * 2,
("data",))`` two shards on one card, each on its own CUDA stream.

Two meshes are equal when their axis names and device arrays are, as
``jax.sharding.Mesh`` compares (``distributed.sharding.NamedSharding``
equality reads it).  ``make_production_mesh`` lays the reference's pod
meshes — (data 16, model 16) and (pod 2, data 16, model 16) — over one
repeated device: ``device="meta"`` for the dry-run (``launch.dryrun``),
the twin of the reference's 512 placeholder host devices.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """``devices`` (any nesting of devices or device strings, or a numpy
    array of them) laid out over ``axis_names``, one name per dimension."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of shape {arr.shape} needs {arr.ndim} axis names; "
                f"got {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = torch.device(d)
        self.axis_names = axis_names

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def make_production_mesh(*, multi_pod: bool = False, device) -> Mesh:
    """The reference's production mesh over ``device`` repeated: (16, 16)
    on ("data", "model"), or (2, 16, 16) on ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.array([torch.device(device)] * int(np.prod(shape)),
                    dtype=object)
    return Mesh(devs.reshape(shape), axes)


def visible_devices() -> list:
    """The distinct visible devices of the engine's device type: the
    machine's cards, or the one CPU."""
    from ..storage import registry
    dev = registry.device()  # raises when CUDA is asked for and absent
    return ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [torch.device("cpu")])


def make_host_mesh(n: int = 0, *, model: int = 1) -> Mesh:
    """A (data, model) mesh over the first ``n`` distinct visible devices
    of the engine's device type — the machine's cards, or the one CPU —
    (all of them when ``n`` is 0), ``data = n // model``.  Never repeats a
    device: build a `Mesh` directly for that."""
    devs = visible_devices()
    n = n or len(devs)
    if n > len(devs):
        raise ValueError(
            f"make_host_mesh({n}) needs {n} distinct devices; "
            f"{len(devs)} visible ({[str(d) for d in devs]}); build a "
            f"Mesh of repeated devices directly to run more shards")
    data = n // model
    if data < 1 or data * model != n:
        raise ValueError(f"{n} devices do not split into model={model}")
    return Mesh(np.array(devs[:n], dtype=object).reshape(data, model),
                ("data", "model"))
