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

Compute.  The ``data`` axes (``pod`` × ``data``) split the batch rows: a
data row is one thread that issues the work of its positions (``Row.tp``:
the positions sharing its data coordinates, one a ``model`` coordinate).
Two layouts of compute:

* tensor-parallel (the dense, MoE, VLM and enc-dec families,
  ``models.tensor_parallel``): position (d, m) computes with its block
  along ``model`` of every leaf, whole along ``d_model`` — ``RowLeaf.at``
  gathers it over the positions that share m (the FSDP all-gather over
  ``data``; in ``serve_mode`` the position holds it whole and gathers
  nothing) — and the sums over ``model`` are ordinary autograd ops on the
  row's thread;
* storage-only (the SSM and hybrid families): the row computes on its first
  position's device (``shard_devices``) with whole layers, which
  ``hint_tree`` gathers from the shards one layer at a time.

Either way a gathered leaf's gradient is added, a layer at a time, into
the blocks of the positions it was gathered from (the reduce-scatter over
``data``): each position holds one gradient block a leaf
(``RowGroup.grads``), into which the rows' parts are added in row order —
rows whose positions share a device take their backwards in turn and a
part is added as it comes; elsewhere a part that arrives early waits in
its slot, and no backward waits.  Activations
are never laid out (``hint`` is the identity): a row's residual stream
lives on its own device.

Serving.  A decode cache laid out by the family's ``cache_axes`` is bound
to a data row as ``RowCache`` leaves: storage-only, the row reads its
batch rows of a layer from the positions holding them (nearest copies)
and writes what it computes back into the blocks of the positions that
share its data coordinates (``Row.owns``), so every block has one writer;
tensor-parallel, each position reads and writes its own block only
(``RowCache.held``, ``put_slot``).

``ACCOUNT`` is the account of a traced step (``launch.hlo_analysis``) or
None: every copy between two mesh positions is reported to it with
``note`` — positions that share a device still count, the mesh's positions
being its devices — each row runs under its ``row_scope`` and each
position's work under ``position`` (``mark`` carries the position into the
backward).
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


def tp_positions(mesh, pos) -> list:
    """The positions that share ``pos``'s data coordinates, in row-major
    order: a data row's positions, one for each coordinate of the other
    axes (``model``)."""
    names = list(mesh.axis_names)
    sizes = np.shape(mesh.devices)
    data = {names.index(a) for a in mesh_data_axes(mesh)}
    rest = [i for i in range(len(names)) if i not in data]
    out = []
    for idx in np.ndindex(*[sizes[i] for i in rest]):
        p = list(pos)
        for i, k in zip(rest, idx):
            p[i] = k
        out.append(tuple(p))
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


@contextlib.contextmanager
def backward_scope(row):
    """The context data row ``row``'s backward runs under: its turn where
    the rows share a device (``RowGroup.backward_turn``), and the
    account's, if any."""
    acc = ACCOUNT
    with contextlib.ExitStack() as stack:
        if row.group is not None and row.group.ordered:
            stack.enter_context(row.group.backward_turn(row))
        if acc is not None:
            stack.enter_context(acc.backward())
        yield


@contextlib.contextmanager
def position(row, j: int):
    """The context position ``row.tp[j]``'s work runs under: its device
    (on a card) and the account's scope of the position."""
    acc = ACCOUNT
    dev = row.tp_device(j)
    with contextlib.ExitStack() as stack:
        if dev.type == "cuda" and dev != row.device:
            stack.enter_context(torch.cuda.device(dev))
        if acc is not None:
            stack.enter_context(acc.position(row, j))
        yield


class _Mark(torch.autograd.Function):
    """The identity, whose backward tells the account that the ops after
    it (in the backward) are position ``j``'s of ``row``."""

    @staticmethod
    def forward(ctx, x, row, j):
        ctx.row, ctx.j = row, j
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        acc = ACCOUNT
        if acc is not None:
            acc.switch(ctx.row, ctx.j)
        return grad, None, None


def mark(x: torch.Tensor, row, j: int) -> torch.Tensor:
    """``x``, marked so that the backward from this point is accounted to
    position ``row.tp[j]`` (only under an account, and only where ``x``
    carries a gradient)."""
    if ACCOUNT is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Mark.apply(x, row, j)


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def _extent(slices) -> tuple:
    """The shape a tuple of unit-step slices selects."""
    return tuple(s.stop - s.start for s in slices)


# ---------------------------------------------------------------------------
# Per-layer gathers: a data row's view of sharded leaves
# ---------------------------------------------------------------------------

class _Chain:
    """The parts of one gradient block's slice (a leaf, a position, a
    stacked index) on their way in: ``next`` the ticket to add next (row r's
    k-th part is ticket k·n + r), ``held`` the parts that came early, and on
    a card the event after which the slice may be written."""

    def __init__(self, n: int, event):
        self.next = 0
        self.held: dict = {}
        self.counts = [0] * n
        self.event = event


def _event(t: torch.Tensor):
    """An event recorded on the current stream of ``t``'s device, where it
    is a card (else None)."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class RowGroup:
    """The data rows of one sharded step: ``n`` rows run; ``positions`` are
    those of every row of the step (more than ``n`` when a traced step runs
    its first row alone).

    The sums the rows take together in the forward (``Row.gather_sum``)
    go through a barrier and one slot list a call.  The gradients go into
    ``grads`` (the leaf's tree name -> {position: its one gradient block},
    one entry a block's first copy, on that position's device in the
    leaf's dtype, zeros at first use): ``add_grad`` adds row r's part of a
    block, weighted by ``weights[r]``, in row order (microbatch by
    microbatch), the same every run.  Where the rows take their backwards
    in turn (``ordered``) the parts come in that order and each is added
    as it comes; else in ticket order — a part that comes before its turn
    waits in its slot, no row waits (a row's k-th part of a block is
    ticket k·n + r)."""

    def __init__(self, n: int, positions=None):
        self.n = n
        self.positions = list(positions) if positions is not None else None
        self.barrier = threading.Barrier(n)
        self.lock = threading.Lock()
        self.slots: dict = {}
        self.weights = [1.0] * n
        self.grads: dict = {}
        self._made: dict = {}
        self._chains: dict = {}
        self.ordered = False
        self._turn = threading.Condition()
        self._served = 0
        self._tickets: dict = {}
        self._aborted = False

    def abort(self):
        """Release every row waiting in the barrier or for its backward's
        turn (a row failed)."""
        self.barrier.abort()
        with self._turn:
            self._aborted = True
            self._turn.notify_all()

    @contextlib.contextmanager
    def backward_turn(self, row: "Row"):
        """Row ``row``'s backward, one at a time, in row order microbatch by
        microbatch: rows whose positions share a device run their backwards
        on its one autograd thread anyway, and in this order each part of
        a gradient block arrives in its turn, none waiting in a slot and
        no two rows' backward temporaries on the device at once."""
        with self._turn:
            k = self._tickets.get(row.index, 0)
            self._tickets[row.index] = k + 1
            ticket = k * self.n + row.index
            self._turn.wait_for(lambda: self._aborted or
                                self._served == ticket)
        try:
            yield
        finally:
            with self._turn:
                self._served += 1
                self._turn.notify_all()

    def add_grad(self, name: str, leaf: "ShardedTensor", pos, index: tuple,
                 sub: tuple, part: torch.Tensor, row: "Row"):
        """Row ``row``'s part of the gradient of ``leaf``'s block at ``pos``
        (its slice ``index`` of the stacked axes, and of that the slices
        ``sub``), moved to the block's device: added into the block in
        ticket order."""
        with self.lock:
            bufs = self.grads.get(name)
            if bufs is None:
                with untracked():
                    bufs = self.grads[name] = {
                        p: torch.zeros(t.shape, dtype=leaf.dtype,
                                       device=t.device)
                        for p, _, t in leaf.blocks()}
                self._made[name] = _event(bufs[pos])
            if part.is_meta:
                return
            key = (name, pos, index)
            ch = self._chains.get(key)
            if ch is None:
                ch = self._chains[key] = _Chain(self.n, self._made[name])
            entry = (sub, part, self.weights[row.index], _event(part))
            if self.ordered:
                self._add(bufs[pos], index, ch, [entry])
                return
            k = ch.counts[row.index]
            ch.counts[row.index] += 1
            ch.held[k * self.n + row.index] = entry
            ready = []
            while ch.next in ch.held:
                ready.append(ch.held.pop(ch.next))
                ch.next += 1
            self._add(bufs[pos], index, ch, ready)

    @staticmethod
    def _add(buf, index, ch, ready):
        """Add ``ready``'s parts, in order, into ``buf[index]`` (after the
        slice's last write and each part's event, on a card)."""
        if not ready or buf.is_meta:
            return
        stream = torch.cuda.current_stream(buf.device) if buf.is_cuda \
            else None
        for sub, part, w, ev in ready:
            if stream is not None:
                for e in (ch.event, ev):
                    if e is not None:
                        stream.wait_event(e)
            buf[index][sub].add_(part, alpha=w)
            if stream is not None and part.is_cuda:
                part.record_stream(stream)
        if stream is not None:
            ch.event = _event(buf)

    def check_done(self):
        """Raise if a part still waits in its slot: a row's loss reached a
        block fewer times than another's, so the block misses a sum."""
        held = [key for key, ch in self._chains.items() if ch.held]
        if held:
            raise RuntimeError(f"gradient parts never added: {held[:4]}")


class Row:
    """One data row of a sharded step: its index, its device, its
    ``group``, its mesh position ``pos`` (``shard_positions``), the mesh
    dims of its data axes, its positions ``tp`` (``tp_positions``: the
    first is ``pos``) and their ``devices``, and a 0-d ``anchor`` that
    makes every gather an autograd node."""

    def __init__(self, index: int, device, group: Optional[RowGroup] = None,
                 pos: Optional[tuple] = None, data_dims: tuple = (),
                 tp: Optional[list] = None, devices: Optional[list] = None):
        self.index = index
        self.device = torch.device(device)
        self.group = group
        self.pos = None if pos is None else tuple(pos)
        self.data_dims = tuple(data_dims)
        self.tp = list(tp) if tp is not None else \
            ([self.pos] if self.pos is not None else [])
        self.devices = [torch.device(d) for d in devices] \
            if devices is not None else [self.device] * len(self.tp)
        self.calls = 0
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)

    def tp_device(self, j: int) -> torch.device:
        """The device of position ``tp[j]``."""
        return self.devices[j]

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
    order) on its position's device, with its positions (``tp_positions``)
    and their devices; the first ``run`` of them (all by default) share
    one ``RowGroup``, which knows every row's position and takes their
    backwards in turn where positions share a device."""
    positions = shard_positions(mesh)
    names = list(mesh.axis_names)
    data_dims = tuple(names.index(a) for a in mesh_data_axes(mesh))
    group = RowGroup(len(positions) if run is None else run, positions)
    rows = []
    for r, pos in enumerate(positions):
        tp = tp_positions(mesh, pos)
        rows.append(Row(r, mesh.devices[pos], group, pos, data_dims, tp,
                        [mesh.devices[p] for p in tp]))
    devs = [torch.device(d) for r in rows[:group.n] for d in r.devices]
    group.ordered = len(set(devs)) < len(devs)
    return rows


def row_of(tree) -> Optional[Row]:
    """The data row a tree's ``RowLeaf`` leaves are bound to, if any."""
    for v in tree.values():
        r = row_of(v) if isinstance(v, dict) else \
            v.row if isinstance(v, RowLeaf) else None
        if r is not None:
            return r
    return None


def _model_dims(leaf: "ShardedTensor", mesh) -> list:
    """The dims of ``leaf`` sharded over an axis other than the data axes
    (``model``); a dim sharded over data and ``model`` together raises."""
    data = set(mesh_data_axes(mesh))
    out = []
    for i, e in enumerate(leaf.sharding.spec):
        axes = _entry_axes(e)
        if any(a not in data for a in axes):
            if any(a in data for a in axes):
                raise ValueError(f"dim {i} of {tuple(leaf.shape)} is "
                                 f"sharded over data and model together "
                                 f"({leaf.sharding.spec})")
            out.append(i)
    return out


class RowLeaf:
    """A sharded leaf (or the slice ``index`` of its leading stacked axes)
    bound to a data row, not yet gathered: ``leaf[i]`` selects layer i,
    ``hint_tree`` gathers it onto the row's device, whole; ``at(j)`` is
    what position ``row.tp[j]`` computes with: its block along ``model``
    (or the range ``span`` of the dim split over ``model``), whole along
    every other dim.  It carries its row, so a gather works on whatever
    thread runs it — autograd recomputes a remat block on its own device
    thread."""

    def __init__(self, leaf: ShardedTensor, row: Row, name: str,
                 index: tuple = (), at: Optional[int] = None,
                 span: Optional[tuple] = None):
        self.leaf, self.row, self.name, self.index = leaf, row, name, index
        self.at_, self.span = at, span
        self.dtype = leaf.dtype
        k = len(index)
        shape = list(leaf.shape[k:])
        if at is not None:
            for d, (lo, hi) in self._ranges().items():
                if d < k:
                    raise ValueError(f"{name}: a stacked axis is sharded "
                                     f"over model ({leaf.sharding.spec})")
                shape[d - k] = hi - lo
        self.shape = tuple(shape)

    def __getitem__(self, i) -> "RowLeaf":
        i = i if isinstance(i, tuple) else (i,)
        return RowLeaf(self.leaf, self.row, self.name, self.index + i,
                       self.at_, self.span)

    def at(self, j: int, span: Optional[tuple] = None) -> "RowLeaf":
        """The leaf as position ``row.tp[j]`` computes with it: its own
        block along ``model``, or ``span`` = (lo, hi) of the (last) dim —
        a range of the dim ``model`` splits, or of a whole one."""
        return RowLeaf(self.leaf, self.row, self.name, self.index, j, span)

    @property
    def target(self) -> tuple:
        """The position the leaf is gathered to."""
        row = self.row
        return row.pos if self.at_ is None else row.tp[self.at_]

    @property
    def device(self) -> torch.device:
        return self.row.device if self.at_ is None else \
            self.row.tp_device(self.at_)

    def model_split(self) -> bool:
        """Whether ``model`` splits the leaf: each position holds a block of
        it (else every position holds the same)."""
        return bool(_model_dims(self.leaf, self.leaf.sharding.mesh))

    def _ranges(self) -> dict:
        """{leaf dim: (lo, hi)} the gather takes of the dims that are not
        whole: the target's block of each dim split over ``model``, or
        ``span`` of the last dim."""
        leaf = self.leaf
        out = {}
        if self.span is not None:
            out[leaf.ndim - 1] = tuple(self.span)
            return out
        mine = leaf.sharding.slices(leaf.shape, self.target)
        for d in _model_dims(leaf, leaf.sharding.mesh):
            out[d] = (mine[d].start, mine[d].stop)
        return out

    def _parts(self) -> list:
        """(first-copy position, the block's slices it takes, where they go
        in the gathered tensor, the position it is read from) of every
        block the gather reads from; computed once a leaf, target and
        range."""
        leaf, k = self.leaf, len(self.index)
        key = (self.target, self.at_ is None, self.span, k)
        cache = leaf.__dict__.setdefault("_parts_cache", {})
        got = cache.get(key)
        if got is not None:
            return got
        ranges = self._ranges() if self.at_ is not None else {}
        out = []
        for pos, sl in leaf.block_slices():
            blk, dst = [], []
            for d, s in enumerate(sl):
                lo, hi = ranges.get(d, (s.start, s.stop))
                a, b = max(lo, s.start), min(hi, s.stop)
                if a >= b:
                    break
                off = lo if d in ranges else 0
                blk.append(slice(a - s.start, b - s.start))
                dst.append(slice(a - off, b - off))
            else:
                if any(x != slice(0, n) for x, n in zip(blk[:k],
                                                        leaf.shape)):
                    raise ValueError(f"{self.name}: a stacked axis is "
                                     f"sharded ({leaf.sharding.spec})")
                out.append((pos, tuple(blk[k:]), tuple(dst[k:]),
                            self._near(pos)))
        cache[key] = out
        return out

    def _near(self, pos) -> tuple:
        row = self.row
        return pos if row.pos is None else \
            self.leaf.sharding.nearest_copy(pos, self.target)

    def assemble(self) -> torch.Tensor:
        """The (layer of the) leaf on the target's device: a view of the
        target's own copy where that holds all it takes, else a new tensor
        filled from the nearest copy of every block it takes (the
        all-gather; its gathered size is what the account counts)."""
        leaf, dev = self.leaf, self.device
        sh = leaf.sharding
        if self.at_ is None and all(e is None for e in sh.spec):
            own = [self.row.pos] if self.row.pos is not None else []
            for pos in own + sh.positions():
                if sh.device(pos) == dev:
                    return leaf.shards[pos][self.index]
        parts = self._parts()
        if self.at_ is not None and len(parts) == 1 and \
                parts[0][3] == self.target:
            return leaf.shards[self.target][self.index][parts[0][1]]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        srcs = []
        for pos, blk, dst, src in parts:
            srcs.append(src)
            if not out.is_meta:
                out[dst] = leaf.shards[src][self.index][blk]
        if self.row.pos is not None:
            note("all-gather", out.nbytes, srcs, self.target,
                 self.row.index)
        return out

    def add_grad(self, grad: torch.Tensor):
        """Add ``grad``, the gradient of the gathered (layer of the) leaf on
        the target's device, into the step's gradient blocks at ``index``:
        each block's part of it moved to the position holding the block's
        first copy and added there in row order (the reduce-scatter;
        ``RowGroup.add_grad``).  A position holds one gradient block of its
        block only, never of the whole leaf."""
        group, src = self.row.group, self.target
        for pos, blk, dst, _ in self._parts():
            part = grad[dst]
            if not grad.is_meta:
                part = part.to(self.leaf.shards[pos].device)
            group.add_grad(self.name, self.leaf, pos, self.index, blk, part,
                           self.row)
            if self.row.pos is not None:
                note("reduce-scatter", _nbytes(_extent(dst), grad.dtype),
                     [src], pos, self.row.index)

    def gather(self) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return self.assemble()
        return _Gather.apply(self.row.anchor, self)


class _Gather(torch.autograd.Function):
    """A ``RowLeaf`` gathered onto its target's device; the backward adds
    each position's part of the gradient into that position's gradient
    block (``RowLeaf.add_grad``), one layer at a time, as
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


def bind_row(params, axes, row: Row, prefix="", *, whole: bool = True):
    """A data row's view of a tree of ``ShardedTensor``: every stacked leaf
    (axes ``layers|…``) a ``RowLeaf`` for ``transformer.train_layer`` to
    gather a layer at a time; every other leaf (embedding, head, norms,
    a hybrid's shared block) gathered now, whole — or, ``whole=False`` (the
    tensor-parallel layout), left a ``RowLeaf`` too, for each position to
    gather its block of."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = bind_row(v, axes[k], row, name + ".", whole=whole)
        elif axes[k].split("|")[0] == "layers" or not whole:
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
        self.put(key, value)

    def put(self, key, value: torch.Tensor, *, src=None,
            kind: Optional[str] = None):
        """Write ``value`` into the row's view at ``key`` (leading ints for
        stacked axes, then slices), on every position the row owns.  ``src``
        is the position ``value`` lies on (the row's by default) and
        ``kind`` names the account's entry (``<kind>-write`` by default)."""
        index, region = self._region(key)
        k, leaf, row = len(index), self.leaf, self.row
        sh = leaf.sharding
        src = row.pos if src is None else tuple(src)
        for pos in sh.positions():
            if not row.owns(pos):
                continue
            cut = self._cut(region, sh.slices(leaf.shape, pos), k)
            if cut is None:
                continue
            if not value.is_meta:
                leaf.shards[pos][cut[0]] = value[cut[1]].to(sh.device(pos))
            note(kind or f"{self.kind}-write",
                 _nbytes(_extent(cut[1]), self.dtype), [src], pos, row.index)

    def copy_(self, value: torch.Tensor) -> "RowCache":
        self[()] = value
        return self

    def commit(self, value: torch.Tensor, *, dim: Optional[int] = None,
               at: Optional[torch.Tensor] = None):
        """Write back what the row changed in a view it ``read``: all of
        ``value``, or only its slot ``at`` (a 0-d int tensor) along view
        dim ``dim`` (``put_slot``)."""
        if at is None:
            self[()] = value
            return
        self.put_slot(value.index_select(dim, at.reshape(1).long()), dim, at)

    def put_slot(self, new: torch.Tensor, dim: int, at: torch.Tensor, *,
                 only=None, src=None):
        """Write ``new`` — the row's view with one index along view dim
        ``dim`` — at index ``at`` (a 0-d int tensor) of that dim: each owned
        block (or position ``only``'s alone) takes the slot where it holds
        that index and keeps its own values elsewhere (a masked
        ``index_copy_``: which block holds it is not read on the host).
        ``src``: the position ``new`` lies on (the row's by default)."""
        index, region = self._region(())
        k, leaf, row = len(index), self.leaf, self.row
        sh = leaf.sharding
        src = row.pos if src is None else tuple(src)
        region[k + dim] = (0, 1)
        for pos in sh.positions():
            if not row.owns(pos) or (only is not None and pos != only):
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
            note(f"{self.kind}-write", part.nbytes, [src], pos, row.index)

    def held(self, pos):
        """(a view of position ``pos``'s own block over the row's view, the
        global [lo, hi) of each view dim it covers), or None where the
        block holds none of the row's view: what the position reads of it,
        copying nothing."""
        index, region = self._region(())
        k, leaf = len(index), self.leaf
        cut = self._cut(region, leaf.sharding.slices(leaf.shape, pos), k)
        if cut is None:
            return None
        span = [(region[k + j][0] + s.start, region[k + j][0] + s.stop)
                for j, s in enumerate(cut[1])]
        return leaf.shards[pos][cut[0]], span

    def local_to_row(self) -> bool:
        """Whether every block holding part of the row's view has a copy on
        one of the row's positions (``Row.tp``): the row's positions can
        compute on the view with no block read by another."""
        index, region = self._region(())
        k, leaf, row = len(index), self.leaf, self.row
        tp = set(row.tp)
        for pos, sl in leaf.block_slices():
            if self._cut(region, sl, k) is None:
                continue
            if not any(leaf.sharding.nearest_copy(pos, q) in tp and
                       leaf.sharding.slices(leaf.shape, q) == sl
                       for q in row.tp):
                return False
        return True


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
