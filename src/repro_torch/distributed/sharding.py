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

Serving.  A decode cache laid out by the family's ``cache_axes`` is bound
to a data row as ``RowCache`` leaves: the row reads its batch rows of a
layer from the positions holding them (nearest copies) and writes what it
computes back into the blocks of the positions that share its data
coordinates (``Row.owns``), so every block has one writer.

``ACCOUNT`` is the account of a traced step (``launch.hlo_analysis``) or
None: every copy between two mesh positions is reported to it with
``note`` — positions that share a device still count, the mesh's positions
being its devices — and each row runs under its ``row_scope``.
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
        return self.nearest_copy(pos, (0,) * len(self.mesh.axis_names))

    def nearest_copy(self, pos, near) -> tuple:
        """The position holding a copy of ``pos``'s block that agrees with
        position ``near`` along every mesh axis the spec leaves
        replicated (a data row reads the copy in its own row or pod)."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(i if a in used else j
                     for a, i, j in zip(self.mesh.axis_names, pos, near))


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

    def block_slices(self) -> list:
        """(position, slices) of every block's first copy, in mesh order
        (computed once a tensor)."""
        got = getattr(self, "_block_slices", None)
        if got is None:
            sh = self.sharding
            got = self._block_slices = [
                (pos, sh.slices(self.shape, pos)) for pos in sh.positions()
                if sh.is_first_copy(pos)]
        return got

    def blocks(self):
        """(position, slices, local tensor) of every block's first copy."""
        for pos, sl in self.block_slices():
            yield pos, sl, self.shards[pos]

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
        if not out.is_meta:
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


def zeros(shape, dtype: torch.dtype, sharding: NamedSharding) -> ShardedTensor:
    """A tensor of zeros laid out by ``sharding``: each position's block
    made on its device, nothing whole anywhere."""
    block = sharding.shard_shape(shape)
    shards = np.empty(np.shape(sharding.mesh.devices), dtype=object)
    for pos in sharding.positions():
        shards[pos] = torch.zeros(block, dtype=dtype,
                                  device=sharding.device(pos))
    return ShardedTensor(shards, sharding, shape, dtype)


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
# The account of a traced step
# ---------------------------------------------------------------------------

#: The account a traced step reports to (``launch.hlo_analysis.Account``),
#: or None.  It takes ``moved(kind, nbytes, srcs, dst, row)``, ``row(row)``
#: (a context each data row runs under), ``untracked(on_device)`` (a
#: context whose allocations are laid out, or hold no device memory) and
#: ``backward()`` (the context a data row's backward runs under).
ACCOUNT = None


def note(kind: str, nbytes: int, srcs, dst, row: Optional[int] = None):
    """Report ``nbytes`` moved to mesh position ``dst`` from ``srcs`` (the
    positions it is read from) to the active account, if any; ``row`` is
    the data row on whose behalf it moves (None for a step-wide copy).
    The account counts it where some source is not ``dst`` itself."""
    acc = ACCOUNT
    if acc is not None and nbytes:
        acc.moved(kind, int(nbytes), [tuple(s) for s in srcs], tuple(dst),
                  row)


def row_scope(row):
    """The context a data row's work runs under (the account's, if any)."""
    acc = ACCOUNT
    return acc.row(row) if acc is not None else contextlib.nullcontext()


def untracked(on_device: bool = True):
    """The context under which a step allocates what it lays out on the
    positions (gradient blocks, caches, outputs): the account counts those
    from their shardings, not as temporaries.  ``on_device=False``: meta
    shapes made for their axes, which hold no device memory at all."""
    acc = ACCOUNT
    return (acc.untracked(on_device) if acc is not None
            else contextlib.nullcontext())


def backward_scope():
    """The context a data row's backward runs under: the account's, which
    may run the rows' backwards one at a time (an account of positions
    sharing one card, whose one autograd thread runs them)."""
    acc = ACCOUNT
    return acc.backward() if acc is not None else contextlib.nullcontext()


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def _extent(slices) -> tuple:
    """The shape a tuple of unit-step slices selects."""
    return tuple(s.stop - s.start for s in slices)


# ---------------------------------------------------------------------------
# Per-layer gathers: a data row's view of sharded leaves
# ---------------------------------------------------------------------------

class RowGroup:
    """The data rows of one sharded step, for the sums they take together
    in the forward (``Row.gather_sum``): a barrier and one slot list a
    call.  ``n`` rows run; ``positions`` are those of every row of the
    step (more than ``n`` when a traced step runs its first row alone)."""

    def __init__(self, n: int, positions=None):
        self.n = n
        self.positions = list(positions) if positions is not None else None
        self.barrier = threading.Barrier(n)
        self.lock = threading.Lock()
        self.slots: dict = {}

    def abort(self):
        """Release every row waiting in the barrier (a row failed)."""
        self.barrier.abort()


class Row:
    """One data row of a sharded step: its index, its device, its
    ``group``, its mesh position ``pos`` (``shard_positions``) and the
    mesh dims of its data axes, the gradients its backward accumulates
    (``grads``: the leaf's tree name -> {position: the row's gradient of
    the block that position holds}, one entry a block's first copy, on
    that position's device in the leaf's dtype — ``RowLeaf.add_grad``) and
    a 0-d ``anchor`` that makes every gather an autograd node."""

    def __init__(self, index: int, device, group: Optional[RowGroup] = None,
                 pos: Optional[tuple] = None, data_dims: tuple = ()):
        self.index = index
        self.device = torch.device(device)
        self.group = group
        self.pos = None if pos is None else tuple(pos)
        self.data_dims = tuple(data_dims)
        self.calls = 0
        self.grads: dict = {}
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)

    def owns(self, pos) -> bool:
        """Whether this row writes position ``pos``'s blocks of what the
        rows compute: ``pos`` shares the row's data coordinates."""
        return all(pos[d] == self.pos[d] for d in self.data_dims)

    def gather_sum(self, value):
        """Σ over the group's rows of ``value`` — each row calls with its
        own, the calls in the same order on every row — added in row
        order on this row's device (a tensor is read after the stream that
        made it has).  The rows wait for one another here, so call it in
        the forward only: autograd's backward threads must never wait.  A
        traced step running its first row alone takes that row's value
        (the sum's shape; meta tensors hold no values)."""
        g = self.group
        if g is None or (g.n == 1 and not g.positions):
            return value
        if isinstance(value, torch.Tensor) and g.positions:
            note("all-reduce", value.nbytes, g.positions, self.pos,
                 self.index)
        if g.n == 1:
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


def mesh_rows(mesh, run: Optional[int] = None) -> list:
    """A ``Row`` for every data row of ``mesh`` (``shard_positions``
    order) on its position's device; the first ``run`` of them (all by
    default) share one ``RowGroup``, which knows every row's position."""
    positions = shard_positions(mesh)
    names = list(mesh.axis_names)
    data_dims = tuple(names.index(a) for a in mesh_data_axes(mesh))
    group = RowGroup(len(positions) if run is None else run, positions)
    return [Row(r, mesh.devices[pos], group, pos, data_dims)
            for r, pos in enumerate(positions)]


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

    def _near(self, pos) -> tuple:
        row = self.row
        return pos if row.pos is None else \
            self.leaf.sharding.nearest_copy(pos, row.pos)

    def assemble(self) -> torch.Tensor:
        """The whole (layer of the) leaf on the row's device: a view of the
        row's own copy when the leaf is replicated, else a new tensor
        filled from the nearest copy of every block (the all-gather; its
        gathered size is what the account counts)."""
        leaf, dev, k = self.leaf, self.row.device, len(self.index)
        sh = leaf.sharding
        if all(e is None for e in sh.spec):
            own = [self.row.pos] if self.row.pos is not None else []
            for pos in own + sh.positions():
                if sh.device(pos) == dev:
                    return leaf.shards[pos][self.index]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        srcs = []
        for pos, sl in leaf.block_slices():
            if any(s != slice(0, n) for s, n in zip(sl[:k], leaf.shape)):
                raise ValueError(f"{self.name}: a stacked axis is sharded "
                                 f"({leaf.sharding.spec})")
            src = self._near(pos)
            srcs.append(src)
            if not out.is_meta:
                out[sl[k:]] = leaf.shards[src][self.index]
        if self.row.pos is not None:
            note("all-gather", out.nbytes, srcs, self.row.pos,
                 self.row.index)
        return out

    def add_grad(self, grad: torch.Tensor):
        """Add ``grad``, the gradient of the gathered (layer of the) leaf on
        the row's device, into the row's gradient blocks at ``index``: each
        block's part of it moved to the position holding the block's first
        copy and added there (the reduce-scatter).  A position holds the
        row's gradient of its block only, never of the whole leaf (zeros at
        first use)."""
        k = len(self.index)
        bufs = self.row.grads.get(self.name)
        if bufs is None:
            with untracked():
                bufs = self.row.grads[self.name] = {
                    pos: torch.zeros(t.shape, dtype=self.dtype,
                                     device=t.device)
                    for pos, _, t in self.leaf.blocks()}
        for pos, sl in self.leaf.block_slices():
            if not grad.is_meta:
                buf = bufs[pos]
                buf[self.index] += grad[sl[k:]].to(buf.device)
            if self.row.pos is not None:
                note("reduce-scatter", _nbytes(_extent(sl[k:]), grad.dtype),
                     [self.row.pos], pos, self.row.index)

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


# ---------------------------------------------------------------------------
# Serving: a data row's view of a sharded cache
# ---------------------------------------------------------------------------

class RowCache:
    """A sharded leaf of a decode cache (or of a step's output) bound to a
    data row: the row's batch rows ``rows`` (a slice of dim ``bdim``) at
    ``index`` of its leading stacked axes.  ``read`` gathers them onto the
    row's device from the nearest copy of every block holding them; item
    assignment, ``copy_`` and ``commit`` write the row's values back into
    the blocks of the positions the row owns (``Row.owns``), on their
    devices — every copy, so replicated blocks stay equal.  ``kind`` names
    the account's entries (``cache`` or ``output``)."""

    def __init__(self, leaf: ShardedTensor, row: Row, bdim: int, rows: slice,
                 index: tuple = (), kind: str = "cache"):
        if bdim < len(index):
            raise ValueError(f"batch dim {bdim} lies under the index {index}")
        self.leaf, self.row, self.bdim, self.rows = leaf, row, bdim, rows
        self.index, self.kind = index, kind

    def __getitem__(self, i) -> "RowCache":
        i = i if isinstance(i, tuple) else (i,)
        return RowCache(self.leaf, self.row, self.bdim, self.rows,
                        self.index + i, self.kind)

    @property
    def shape(self) -> tuple:
        """The row's view: the leaf's shape past ``index``, its batch dim
        the row's rows."""
        s = list(self.leaf.shape)
        s[self.bdim] = self.rows.stop - self.rows.start
        return tuple(s[len(self.index):])

    @property
    def dtype(self) -> torch.dtype:
        return self.leaf.dtype

    def _region(self, key) -> tuple:
        """(index, [(lo, hi) global per leaf dim]) of ``key`` — leading
        ints extending ``index``, then slices over the view's dims."""
        key = key if isinstance(key, tuple) else (key,)
        index = self.index
        while key and isinstance(key[0], int) and len(index) < self.bdim:
            index, key = index + (key[0],), key[1:]
        k = len(index)
        view = list(self.leaf.shape[k:])
        view[self.bdim - k] = self.rows.stop - self.rows.start
        if len(key) > len(view) or any(not isinstance(x, slice) or
                                       x.step not in (None, 1) for x in key):
            raise ValueError(f"RowCache: key {key} is not slices of {view}")
        region = [(i, i + 1) for i in index]
        for j, n in enumerate(view):
            lo, hi, _ = (key[j] if j < len(key) else slice(None)).indices(n)
            off = self.rows.start if j + k == self.bdim else 0
            region.append((lo + off, max(lo, hi) + off))
        return index, region

    @staticmethod
    def _cut(region, sl, k):
        """(block-local index, value-local index) of a region's overlap
        with a block's slices, or None: ints on the ``k`` stacked dims."""
        blk, val = [], []
        for d, ((lo, hi), s) in enumerate(zip(region, sl)):
            a, b = max(lo, s.start), min(hi, s.stop)
            if a >= b:
                return None
            if d < k:
                blk.append(a - s.start)
            else:
                blk.append(slice(a - s.start, b - s.start))
                val.append(slice(a - lo, b - lo))
        return tuple(blk), tuple(val)

    def read(self) -> torch.Tensor:
        """The row's view gathered onto its device: a new tensor."""
        index, region = self._region(())
        k, leaf, row = len(index), self.leaf, self.row
        out = torch.empty(self.shape, dtype=self.dtype, device=row.device)
        for pos, sl in leaf.block_slices():
            cut = self._cut(region, sl, k)
            if cut is None:
                continue
            src = leaf.sharding.nearest_copy(pos, row.pos)
            if not out.is_meta:
                out[cut[1]] = leaf.shards[src][cut[0]]
            note(f"{self.kind}-read", _nbytes(_extent(cut[1]), self.dtype),
                 [src], row.pos, row.index)
        return out

    def __setitem__(self, key, value: torch.Tensor):
        """Write ``value`` into the row's view at ``key`` (leading ints for
        stacked axes, then slices), on every position the row owns."""
        index, region = self._region(key)
        k, leaf, row = len(index), self.leaf, self.row
        sh = leaf.sharding
        for pos in sh.positions():
            if not row.owns(pos):
                continue
            cut = self._cut(region, sh.slices(leaf.shape, pos), k)
            if cut is None:
                continue
            if not value.is_meta:
                leaf.shards[pos][cut[0]] = value[cut[1]].to(sh.device(pos))
            note(f"{self.kind}-write", _nbytes(_extent(cut[1]), self.dtype),
                 [row.pos], pos, row.index)

    def copy_(self, value: torch.Tensor) -> "RowCache":
        self[()] = value
        return self

    def commit(self, value: torch.Tensor, *, dim: Optional[int] = None,
               at: Optional[torch.Tensor] = None):
        """Write back what the row changed in a view it ``read``: all of
        ``value``, or only its slot ``at`` (a 0-d int tensor) along view
        dim ``dim`` — each owned block takes the slot where it holds that
        index and keeps its own values elsewhere (a masked
        ``index_copy_``: which block holds it is not read on the host)."""
        if at is None:
            self[()] = value
            return
        index, region = self._region(())
        k, leaf, row = len(index), self.leaf, self.row
        sh = leaf.sharding
        new = value.index_select(dim, at.reshape(1).long())
        region[k + dim] = (0, 1)
        for pos in sh.positions():
            if not row.owns(pos):
                continue
            sl = list(sh.slices(leaf.shape, pos))
            lo = sl[k + dim].start
            n = sl[k + dim].stop - lo
            sl[k + dim] = slice(0, 1)
            cut = self._cut(region, sl, k)
            if cut is None:
                continue
            dev = sh.device(pos)
            blk_idx = list(cut[0])
            blk_idx[k + dim] = slice(None)
            blk = leaf.shards[pos][tuple(blk_idx)]
            part = new[cut[1]].to(dev)
            loc = (at.reshape(1).long().to(dev) - lo)
            ok = ((loc >= 0) & (loc < n)).reshape([1] * part.ndim)
            loc = loc.clamp(0, n - 1)
            blk.index_copy_(dim, loc, torch.where(
                ok, part, blk.index_select(dim, loc)))
            note(f"{self.kind}-write", part.nbytes, [row.pos], pos,
                 row.index)


def row_rows(mesh, batch: int, pos) -> slice:
    """The batch rows the data row at ``pos`` computes when serving: its
    block of a ``batch``-axis input laid out on ``mesh`` (all rows where
    the batch does not split, as the reference replicates it)."""
    return sharding_for("batch", (batch,), mesh).slices((batch,), pos)[0]


def bind_cache(cache, axes, row: Row, rows: slice):
    """A data row's view of a cache tree of ``ShardedTensor`` laid out by
    ``axes`` (the family's ``cache_axes``): every leaf with a ``batch``
    axis a ``RowCache`` of the row's ``rows``; ``len`` (a replicated
    scalar) the row's own copy."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = bind_cache(v, axes[k], row, rows)
        elif "batch" in axes[k].split("|"):
            out[k] = RowCache(v, row, axes[k].split("|").index("batch"), rows)
        else:
            out[k] = v.local(row.pos)
    return out
