"""Logical-axis sharding policy — the port of repro.distributed.sharding:
the engine's half and the LM half.

Every engine matrix dimension, parameter, moment and batch dimension
carries a logical axis name ('|'-joined, as in ``"rows|rep"`` or
``"layers|d_model|heads"``).  ``resolve`` maps them to a spec for the
active mesh with divisibility-checked greedy assignment:

* each logical axis has an ordered candidate list of mesh-axis groups;
* a candidate is taken iff every component mesh axis is still unused in
  this tensor's spec and the dim size divides evenly;
* otherwise fall through (ultimately replicate).

A spec is a plain tuple, one entry per dimension: ``None`` (replicated),
an axis name, or a tuple of names (sharded over their product) — the
counterpart of a ``PartitionSpec``.  Every function here takes any object
with ``axis_names`` and a numpy ``devices`` array: a `launch.mesh.Mesh`, or
a stand-in with the same two attributes.

The LM half.  ``NamedSharding`` is a mesh and a spec; ``sharding_for`` /
``tree_shardings`` resolve one leaf or a tree of them.  A
``ShardedTensor`` is a leaf laid out by one: a local tensor per mesh
position, on that position's device, holding the position's block — the
counterpart of a sharded ``jax.Array`` — and ``place`` makes one (the
counterpart of ``jax.device_put(x, sharding)``).  Parameter ``d_model``
dims shard over ``data`` (FSDP: parameters and AdamW moments), vocab,
heads, d_ff, d_inner and experts over ``model``.

Compute.  The ``data`` axes (``pod`` × ``data``) split the batch rows:
each data row computes on its first position's device (``shard_devices``)
with whole layers, which ``hint_tree`` gathers from the shards one layer
at a time (``RowLeaf``) — the reference's per-layer FSDP all-gather — and
whose gradient the backward adds, a layer at a time, into the row's
gradient of each position's block on that position's device (the
reduce-scatter; the rows' blocks are summed in row order after).  The
``model`` axis splits storage only: no matmul is split over it, so a
position on it stores a slice of every leaf and the data row's device
computes the whole layer.  Activations are never sharded (``hint`` is the
identity): a data row's activations live on its own device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

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
    return [mesh.devices[pos] for pos in shard_positions(mesh)]


def shard_positions(mesh) -> list:
    """The mesh position of each data shard's device (``shard_devices``),
    in row-shard order: index 0 along every non-data axis."""
    names = list(mesh.axis_names)
    sizes = np.shape(mesh.devices)
    data = [names.index(a) for a in mesh_data_axes(mesh)]
    out = []
    for idx in np.ndindex(*[sizes[i] for i in data]):
        pos = [0] * len(names)
        for i, k in zip(data, idx):
            pos[i] = k
        out.append(tuple(pos))
    return out


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


def hint(x, axes: str):
    """The identity.  The reference constrains an activation's sharding
    here; in the port a data row's activations live whole on the row's
    device (nothing splits them over ``model``), so there is nothing to
    constrain."""
    del axes
    return x


# ---------------------------------------------------------------------------
# The LM half: shardings, sharded leaves, placement
# ---------------------------------------------------------------------------

def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A mesh and the spec ``resolve`` returns for it: the twin of
    ``jax.sharding.NamedSharding``.  Equal when the meshes are equal and
    the specs are."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.spec == other.spec
                and self.mesh == other.mesh)

    def __hash__(self):
        return hash((self.spec, tuple(self.mesh.axis_names),
                     np.shape(self.mesh.devices)))

    def __repr__(self):
        return (f"NamedSharding(mesh={_mesh_sizes(self.mesh)}, "
                f"spec={self.spec})")

    def positions(self) -> list:
        """Every mesh position, in row-major order."""
        return list(np.ndindex(np.shape(self.mesh.devices)))

    def device(self, pos) -> torch.device:
        return torch.device(self.mesh.devices[pos])

    def _check(self, shape):
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")

    def shard_shape(self, shape) -> tuple:
        """The shape of one position's block of a ``shape`` tensor."""
        self._check(shape)
        sizes = _mesh_sizes(self.mesh)
        out = []
        for i, dim in enumerate(shape):
            n = int(np.prod([sizes[a] for a in _entry_axes(
                self.spec[i] if i < len(self.spec) else None)] or [1]))
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"{n} ways ({self.spec})")
            out.append(dim // n)
        return tuple(out)

    def slices(self, shape, pos) -> tuple:
        """Position ``pos``'s block of a ``shape`` tensor, one slice a dim:
        a dim sharded over several axes is split row-major over them."""
        names = list(self.mesh.axis_names)
        sizes = _mesh_sizes(self.mesh)
        block = self.shard_shape(shape)
        out = []
        for i, n in enumerate(block):
            k = 0
            for a in _entry_axes(self.spec[i] if i < len(self.spec)
                                 else None):
                k = k * sizes[a] + pos[names.index(a)]
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def is_first_copy(self, pos) -> bool:
        """Whether ``pos`` holds the first copy of its block: its index is
        0 along every mesh axis the spec leaves replicated."""
        return tuple(pos) == self.first_copy(pos)

    def first_copy(self, pos) -> tuple:
        """The position holding the first copy of ``pos``'s block: ``pos``
        with index 0 along every mesh axis the spec leaves replicated."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(i if a in used else 0
                     for a, i in zip(self.mesh.axis_names, pos))


class ShardedTensor:
    """A tensor of ``shape`` laid out on a mesh by ``sharding``: one local
    tensor per mesh position (``shards``, a numpy object array of the
    mesh's shape), on that position's device, holding the position's block
    — no position holds more.  Positions along an axis the spec leaves
    replicated hold equal copies.  ``full`` gathers it onto one device,
    ``numpy`` onto the host."""

    def __init__(self, shards: np.ndarray, sharding: NamedSharding, shape,
                 dtype: torch.dtype):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return self.shape.numel()

    @property
    def device(self) -> torch.device:
        """The first position's device."""
        return self.local(self.sharding.positions()[0]).device

    def local(self, pos) -> torch.Tensor:
        return self.shards[tuple(pos)]

    def blocks(self):
        """(position, slices, local tensor) of every block's first copy."""
        sh = self.sharding
        for pos in sh.positions():
            if sh.is_first_copy(pos):
                yield pos, sh.slices(self.shape, pos), self.shards[pos]

    def map(self, fn) -> "ShardedTensor":
        """``fn`` of every local tensor, in the same layout (``fn`` keeps
        each local shape)."""
        out = np.empty(self.shards.shape, dtype=object)
        for pos in self.sharding.positions():
            out[pos] = fn(self.shards[pos])
        first = out[self.sharding.positions()[0]]
        return ShardedTensor(out, self.sharding, self.shape, first.dtype)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first position's by
        default), assembled from the first copy of every block."""
        dev = self.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for _, sl, t in self.blocks():
            out[sl] = t
        return out

    def numpy(self) -> np.ndarray:
        """The whole tensor on the host (bf16 as float32, exactly)."""
        t = self.full("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, {self.sharding})")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":            # ml_dtypes: the raw payload
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def place(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a tensor, numpy array or ``ShardedTensor``) laid out by
    ``sharding`` in its own dtype: each position's block copied onto the
    position's device — the twin of ``jax.device_put(x, sharding)``.  A
    ``ShardedTensor`` is gathered first (a reshard)."""
    if isinstance(x, ShardedTensor):
        x = x.full()
    x = _as_tensor(x)
    shape = tuple(x.shape)
    block = sharding.shard_shape(shape)
    shards = np.empty(np.shape(sharding.mesh.devices), dtype=object)
    for pos in sharding.positions():
        t = torch.empty(block, dtype=x.dtype, device=sharding.device(pos))
        shards[pos] = t.copy_(x[sharding.slices(shape, pos)])
    return ShardedTensor(shards, sharding, shape, x.dtype)


def sharding_for(axes: str, shape, mesh) -> NamedSharding:
    return NamedSharding(mesh, resolve(axes, shape, mesh))


def tree_map(fn, *trees):
    """``fn`` of the leaves at each place of trees of dicts with the first
    tree's keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_shardings(axes_tree, shapes_tree, mesh):
    """(axes, tensor-or-meta-tensor) trees -> the tree of ``NamedSharding``:
    each leaf's axes resolved at its shape."""
    return tree_map(lambda ax, s: sharding_for(ax, tuple(s.shape), mesh),
                     axes_tree, shapes_tree)


def place_tree(tree, shardings):
    """``place`` of every leaf of ``tree`` by its sharding."""
    return tree_map(place, tree, shardings)


# ---------------------------------------------------------------------------
# Per-layer gathers: a data row's view of sharded leaves
# ---------------------------------------------------------------------------

class RowGroup:
    """The data rows of one sharded step, for the sums they take together
    in the forward (``Row.gather_sum``): a barrier and one slot list a
    call."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.lock = threading.Lock()
        self.slots: dict = {}

    def abort(self):
        """Release every row waiting in the barrier (a row failed)."""
        self.barrier.abort()


class Row:
    """One data row of a sharded train step: its index, its device, its
    ``group``, the gradients its backward accumulates (``grads``: the
    leaf's tree name -> {position: the row's gradient of the block that
    position holds}, one entry a block's first copy, on that position's
    device in the leaf's dtype — ``RowLeaf.add_grad``) and a 0-d
    ``anchor`` that makes every gather an autograd node."""

    def __init__(self, index: int, device, group: Optional[RowGroup] = None):
        self.index = index
        self.device = torch.device(device)
        self.group = group
        self.calls = 0
        self.grads: dict = {}
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)

    def gather_sum(self, value):
        """Σ over the group's rows of ``value`` — each row calls with its
        own, the calls in the same order on every row — added in row
        order on this row's device (a tensor is read after the stream that
        made it has).  The rows wait for one another here, so call it in
        the forward only: autograd's backward threads must never wait."""
        g = self.group
        if g is None or g.n == 1:
            return value
        ev = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        k, self.calls = self.calls, self.calls + 1
        with g.lock:
            g.slots.setdefault(k, [None] * g.n)[self.index] = (value, ev)
        g.barrier.wait()
        total = 0
        for v, e in g.slots[k]:
            if e is not None:
                torch.cuda.current_stream(self.device).wait_event(e)
            total = total + (v.to(self.device)
                             if isinstance(v, torch.Tensor) else v)
        return total


def row_of(tree) -> Optional[Row]:
    """The data row a tree's ``RowLeaf`` leaves are bound to, if any."""
    for v in tree.values():
        r = row_of(v) if isinstance(v, dict) else \
            v.row if isinstance(v, RowLeaf) else None
        if r is not None:
            return r
    return None


class RowLeaf:
    """A sharded leaf (or the slice ``index`` of its leading stacked axes)
    bound to a data row, not yet gathered: ``leaf[i]`` selects layer i,
    ``hint_tree`` gathers it onto the row's device.  It carries its row, so
    a gather works on whatever thread runs it — autograd recomputes a
    remat block on its own device thread."""

    def __init__(self, leaf: ShardedTensor, row: Row, name: str,
                 index: tuple = ()):
        self.leaf, self.row, self.name, self.index = leaf, row, name, index
        self.shape = leaf.shape[len(index):]
        self.dtype = leaf.dtype

    def __getitem__(self, i) -> "RowLeaf":
        i = i if isinstance(i, tuple) else (i,)
        return RowLeaf(self.leaf, self.row, self.name, self.index + i)

    def assemble(self) -> torch.Tensor:
        """The whole (layer of the) leaf on the row's device: a view of a
        copy on that device when the leaf is replicated, else a new tensor
        filled from the first copy of every block."""
        leaf, dev, k = self.leaf, self.row.device, len(self.index)
        sh = leaf.sharding
        if all(e is None for e in sh.spec):
            for pos in sh.positions():
                if sh.device(pos) == dev:
                    return leaf.shards[pos][self.index]
        blocks = list(leaf.blocks())
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for _, sl, t in blocks:
            if any(s != slice(0, n) for s, n in zip(sl[:k], leaf.shape)):
                raise ValueError(f"{self.name}: a stacked axis is sharded "
                                 f"({leaf.sharding.spec})")
            out[sl[k:]] = t[self.index]
        return out

    def add_grad(self, grad: torch.Tensor):
        """Add ``grad``, the gradient of the gathered (layer of the) leaf on
        the row's device, into the row's gradient blocks at ``index``: each
        block's part of it moved to the position holding the block's first
        copy and added there.  A position holds the row's gradient of its
        block only, never of the whole leaf (zeros at first use)."""
        k = len(self.index)
        bufs = self.row.grads.get(self.name)
        if bufs is None:
            bufs = self.row.grads[self.name] = {
                pos: torch.zeros(t.shape, dtype=self.dtype, device=t.device)
                for pos, _, t in self.leaf.blocks()}
        for pos, sl, _ in self.leaf.blocks():
            buf = bufs[pos]
            buf[self.index] += grad[sl[k:]].to(buf.device)

    def gather(self) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return self.assemble()
        return _Gather.apply(self.row.anchor, self)


class _Gather(torch.autograd.Function):
    """A ``RowLeaf`` gathered onto its row's device; the backward adds each
    position's part of the gradient into the row's gradient of that
    position's block (``RowLeaf.add_grad``), one layer at a time, as
    ``transformer._LayerSlice`` adds into ``.grad``.  Nothing flows to the
    anchor."""

    @staticmethod
    def forward(ctx, anchor, leaf):
        ctx.leaf = leaf
        return leaf.assemble()

    @staticmethod
    def backward(ctx, grad):
        ctx.leaf.add_grad(grad)
        return None, None


def bind_row(params, axes, row: Row, prefix=""):
    """A data row's view of a tree of ``ShardedTensor``: every stacked leaf
    (axes ``layers|…``) a ``RowLeaf`` for ``transformer.train_layer`` to
    gather a layer at a time; every other leaf (embedding, head, norms,
    a hybrid's shared block) gathered now, whole."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = bind_row(v, axes[k], row, name + ".")
        elif axes[k].split("|")[0] == "layers":
            out[k] = RowLeaf(v, row, name)
        else:
            out[k] = RowLeaf(v, row, name).gather()
    return out


def hint_tree(tree, axes_tree=None):
    """Gather every ``RowLeaf`` of ``tree`` onto its row's device; any
    other leaf passes through (the identity without a mesh, as the
    reference's).  The twin of the reference's per-slice constraint that
    keeps the FSDP all-gather inside the layer loop: called on one layer's
    leaves, it gathers that layer only, so a data row holds one layer's
    gathered parameters beside its shards (under ``cfg.remat`` the gather
    is recomputed in the backward, not kept)."""
    del axes_tree
    return {k: hint_tree(v) if isinstance(v, dict) else
            v.gather() if isinstance(v, RowLeaf) else v
            for k, v in tree.items()}
