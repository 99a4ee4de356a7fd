"""The account of one step over a mesh — the port's counterpart of
repro/launch/hlo_analysis.py, which reads XLA's post-SPMD HLO.

The port has no HLO: it runs the step.  ``Account`` reads the dispatched
op stream of a step run on the ``meta`` device (``steps.lower_cell``),
which holds no data, allocates nothing and computes nothing, over a mesh
of repeated meta devices (``launch.mesh.make_production_mesh(device=
"meta")``).  Eager PyTorch runs every layer of a step, so the reference's
problem — XLA-CPU counting a ``while`` body once — does not arise: the
account counts what runs.  Per mesh position it records:

* dot FLOPs: the matmul family of aten ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), counted by ``torch.utils.flop_counter``'s formulas as
  ``FlopCounterMode`` counts them, by the dtype they run in (bf16 runs on
  the tensor cores, f32 — TF32 off — on the FMA units);
* the hand-written kernels' work: a wrapper handed meta tensors under an
  account (``kernels.common.route``) returns an empty output and reports
  the FLOPs and HBM bytes of the tiles its kernel visits;
* collectives by kind, with count and bytes: every copy between two
  positions that ``distributed.sharding``, the steps and
  ``models.tensor_parallel`` make (``sharding.note``) — ``all-gather`` (a
  layer, or a position's block of it, gathered onto the position that
  computes with it, counted at its gathered size, the reference's
  convention; a gathered input; in a tensor-parallel decode the token's
  Q/K/V columns and the heads' partials), ``reduce-scatter`` (each
  block's part of a row's gradient, at the block's position),
  ``all-reduce`` (``Row.gather_sum``; a sum over ``model`` and the loss's
  max and sums, each position receiving the partial's bytes),
  ``all-to-all`` (a tensor-parallel prefill's K/V moved from the
  position computing a KV head into the sequence-split cache blocks),
  ``broadcast`` (a gradient block copied to a replicated block's other
  positions), ``cache-read`` / ``cache-write`` (a row's reads and
  write-backs of the decode cache), ``output-write`` (its logits into
  their positions) and ``all-reduce-int8`` (``optim.compression``'s round
  over ``pod``).  Positions that share a device still count: the mesh's
  positions are its devices.  Each entry is attributed to the position
  the bytes go to, and splits off the bytes whose copy crosses a node of
  8 consecutive positions (``inter_node_bytes``);
* bytes: ``argument_bytes`` and ``output_bytes`` are the blocks a position
  holds (``NamedSharding.shard_shape``): parameters, moments, batch and
  cache in; the gradient blocks (one a parameter block), a prefill's
  cache, logits and ``len`` out.  ``temp_bytes`` is the peak of the live
  bytes of the storages created for the position's work (each counted
  until a finalizer sees it freed): a data row's thread works for its
  first position and, under ``sharding.position`` (or in the backward
  after a ``sharding.mark``), for each of its others; the calling
  thread's (the gradients' layout, AdamW's slices) count at position 0.  ``peak_device_bytes``
  is their sum, the reference's, whose ``alias_bytes`` is 0 here: the
  port donates nothing, and what a step updates in place (parameters,
  moments, a decode cache) is not an output.

A dispatch mode does not follow a thread, so the account enters its mode
on the calling thread and in each data row's thread (``sharding.row_scope``);
on meta, autograd's backward runs on the calling thread, a checkpointed
block's recompute included.  Every data row has the same shapes
(``steps._row_batch`` splits evenly, a served batch splits or replicates),
so by default (``first_row``) the step runs row 0 — which issues the work
of all its positions — and one microbatch, the account scales them by
``micro`` (``grad_accum``) and gives every position what the position of
row 0 with its ``model`` coordinate had, its copies translated along the
data axes; the record says so (``rows_traced``).  Where every row is
traced, their backwards run one at a time in row order, as the rows of
one device's positions do (``sharding.RowGroup.backward_turn``).

Positions sharing one card.  Each position's ``peak_device_bytes`` is its
own device's, whose rows peak together.  Where every position lies on one
card (a mesh of repeated ``cuda:0``), the card holds them all at once and
its peak is the peak over time of their sum: ``one_device`` traces every
row, counts every allocation of the step into one running total that
starts from all the arguments' bytes, and runs the rows' backwards one at
a time, as the card's one autograd thread does; the record's
``device_peak_bytes`` is that total's peak.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..distributed import sharding as shd
from ..kernels import common

aten = torch.ops.aten
#: The matmul family: the ops whose FLOPs are the dot FLOPs.
DOT_OPS = tuple(p for p in (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
                if p in flop_registry)
#: Positions a node holds: a collective inside one takes NVLink.
NODE_POSITIONS = 8
#: Copies whose destination is the block's position, the same for every
#: data row (a row's gradient part goes to the block's first copy): the
#: first-row shortcut moves their sources only.
FIXED_DST = ("reduce-scatter",)


class _Slot:
    """What one thread's work adds up to: dot FLOPs by dtype, kernels, and
    the live bytes of the storages it created (their peak)."""

    def __init__(self, pos, scale: int):
        self.pos, self.scale = pos, scale
        self.flops: dict = {}
        self.kernels: dict = {}
        self.cur = self.peak = 0


class _Meter(TorchDispatchMode):
    """Counts each dispatched op into the thread's current slot (a
    position's, under ``Account.position`` or after a ``sharding.mark``
    in the backward); of meters nested on one thread the innermost
    counts."""

    def __init__(self, account):
        super().__init__()
        self.account = account

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tls = self.account._tls
        if getattr(tls, "meter", None) is not self:
            return out        # a row scope nested on this thread counts it
        slot = tls.slot
        packet = func._overloadpacket
        if packet in DOT_OPS:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            key = str(out.dtype).replace("torch.", "")
            slot.flops[key] = slot.flops.get(key, 0) + n * slot.scale
        self.account._track(slot, out)
        return out


class Account:
    """The account of one step on ``mesh`` (a context: while it is active
    the sharding code and the kernel wrappers report to it).  ``first_row``
    runs the first data row and microbatch alone, scaled by ``micro``."""

    def __init__(self, mesh, *, first_row: bool = True, micro: int = 1,
                 one_device: bool = False):
        self.mesh = mesh
        self.first_row = first_row and not one_device
        self.micro = micro
        self.one_device = one_device
        self.shape = tuple(np.shape(mesh.devices))
        self.events: list = []       # (kind, bytes, scale, srcs, dst, row)
        self.slots: list = []        # the caller's first, then the rows'
        self.known: dict = {}        # storages laid out or off the device
        self.live: dict = {}         # storage -> (its slot, bytes)
        self.args: dict = {}         # position -> argument bytes
        self.outs: dict = {}         # position -> output bytes
        self.dev_cur = self.dev_peak = 0
        self.record: dict = {}
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._row_positions = shd.shard_positions(mesh)
        names = list(mesh.axis_names)
        self._data_dims = [names.index(a) for a in shd.mesh_data_axes(mesh)]

    # -- the hooks ---------------------------------------------------------

    def __enter__(self):
        if shd.ACCOUNT is not None or common.METER is not None:
            raise RuntimeError("an account is already active")
        shd.ACCOUNT = common.METER = self
        self._caller = self._scope(self._pos0(), 1)
        self._caller.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._caller.__exit__(*exc)
        finally:
            shd.ACCOUNT = common.METER = None

    def _pos0(self):
        return (0,) * len(self.shape)

    def _slot(self, pos, scale) -> _Slot:
        slot = _Slot(tuple(pos), scale)
        with self._lock:
            self.slots.append(slot)
        return slot

    @contextlib.contextmanager
    def _scope(self, pos, scale):
        slot = self._slot(pos, scale)
        tls = self._tls
        prev = (getattr(tls, "slot", None), getattr(tls, "mode", None),
                getattr(tls, "meter", None), getattr(tls, "positions", None))
        meter = _Meter(self)
        tls.slot, tls.mode, tls.meter, tls.positions = slot, None, meter, \
            {0: slot}
        try:
            with meter:
                yield slot
        finally:
            tls.slot, tls.mode, tls.meter, tls.positions = prev

    def row(self, row):
        """The context a data row runs under: its thread's meter, its work
        scaled by ``micro`` when it stands for every microbatch; its
        position 0's slot."""
        return self._scope(row.pos, self.micro if self.first_row else 1)

    def _position_slot(self, row, j) -> _Slot:
        """The slot of the row's position j (the row scope's own for j =
        0), one for the row's scope."""
        got = self._tls.positions.get(j)
        if got is None:
            got = self._tls.positions[j] = self._slot(
                row.tp[j], self._tls.positions[0].scale)
        return got

    @contextlib.contextmanager
    def position(self, row, j: int):
        """The context position ``row.tp[j]``'s work runs under: its slot
        (its FLOPs, kernels and live bytes)."""
        tls = self._tls
        prev = tls.slot
        tls.slot = self._position_slot(row, j)
        try:
            yield
        finally:
            tls.slot = prev

    def switch(self, row, j: int):
        """From here on the thread's work is position ``row.tp[j]``'s (a
        ``sharding.mark`` reached in the backward)."""
        if getattr(self._tls, "positions", None):
            self._tls.slot = self._position_slot(row, j)

    @contextlib.contextmanager
    def untracked(self, on_device: bool = True):
        """Allocations inside are laid out (their bytes counted from the
        shardings), not temporaries — or, ``on_device=False``, hold no
        device memory at all (meta shapes): their storages become known."""
        prev = getattr(self._tls, "mode", None)
        self._tls.mode = "laid" if on_device else "off"
        try:
            yield
        finally:
            self._tls.mode = prev

    @contextlib.contextmanager
    def backward(self):
        """A data row's backward, after which the thread's work is its
        position 0's again."""
        tls = self._tls
        try:
            yield
        finally:
            if getattr(tls, "positions", None):
                tls.slot = tls.positions[0]

    def moved(self, kind, nbytes, srcs, dst, row):
        slot = getattr(self._tls, "slot", None)
        scale = slot.scale if slot is not None else 1
        self.events.append((kind, nbytes, scale, tuple(srcs), dst, row))

    def kernel(self, name: str, flops: float, nbytes: float, dtype: str):
        """A kernel wrapper's launch on meta tensors: its FLOPs (at the
        rate of ``dtype``: ``bfloat16`` tensor cores or ``float32`` FMA)
        and HBM bytes, into the calling thread's slot."""
        slot = getattr(self._tls, "slot", None) or self.slots[0]
        k = slot.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0, "dtype": dtype})
        k["launches"] += slot.scale
        k["flops"] += flops * slot.scale
        k["bytes"] += nbytes * slot.scale

    # -- storages ----------------------------------------------------------

    def lay_out(self, args):
        """The step's arguments (``ShardedTensor`` trees): each position's
        blocks as argument bytes, their storages known."""
        self._add_blocks(self.args, args)
        seen = set()
        for t in _locals(args):
            st = t.untyped_storage()
            self._know(st)
            if st._cdata not in seen:
                seen.add(st._cdata)
                self.dev_cur += st.nbytes()
        self.dev_peak = self.dev_cur

    def _add_blocks(self, into: dict, tree, *, times=None):
        for leaf in _leaves(tree):
            if not isinstance(leaf, shd.ShardedTensor):
                continue
            sh = leaf.sharding
            nb = shd._nbytes(sh.shard_shape(leaf.shape), leaf.dtype)
            for pos in sh.positions():
                k = 1 if times is None else times(sh, pos)
                into[pos] = into.get(pos, 0) + k * nb

    def _know(self, st):
        key = st._cdata
        if key not in self.known:
            self.known[key] = True
            weakref.finalize(st, self.known.pop, key, None)

    def _track(self, slot: _Slot, out):
        """Count the storages of ``out`` new to the account as the slot's
        live bytes until they are freed (a finalizer takes them off), and
        under ``one_device`` into the card's running total."""
        mode = getattr(self._tls, "mode", None)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.live:
                continue
            if mode is not None:
                self._know(st)
                if mode == "laid":
                    self._on_device(st)
                continue
            nb = st.nbytes()
            with self._lock:
                self.live[key] = (slot, nb)
                slot.cur += nb
                slot.peak = max(slot.peak, slot.cur)
            weakref.finalize(st, self._free, key)
            self._on_device(st)

    def _on_device(self, st):
        if not self.one_device:
            return
        nb = st.nbytes()
        with self._lock:
            self.dev_cur += nb
            self.dev_peak = max(self.dev_peak, self.dev_cur)
        weakref.finalize(st, self._dev_free, nb)

    def _dev_free(self, nb):
        with self._lock:
            self.dev_cur -= nb

    def _free(self, key):
        with self._lock:
            slot, nb = self.live.pop(key)
            slot.cur -= nb

    # -- the record --------------------------------------------------------

    def _node(self, pos) -> int:
        flat = 0
        for i, n in zip(pos, self.shape):
            flat = flat * n + i
        return flat // NODE_POSITIONS

    def _shift(self, pos, by):
        """``pos`` moved along the data axes by row position ``by``."""
        out = list(pos)
        for d in self._data_dims:
            out[d] = (pos[d] + by[d]) % self.shape[d]
        return tuple(out)

    def finish(self, out, kind: str):
        """Make the record from the step's output ``out`` and the events."""
        n_rows = len(self._row_positions)
        if kind == "train":
            self._add_blocks(self.outs, out[0])      # one gradient block
        elif kind == "prefill":
            self._add_blocks(self.outs, out)
        else:
            self._add_blocks(self.outs, (out[0]["len"], out[1]))
        positions = list(np.ndindex(self.shape))
        per = {p: {"dot_flops": {}, "kernels": {}, "collectives": {},
                   "temp_bytes": 0} for p in positions}
        row_slots = self.slots[1:]
        shifts = (self._row_positions if self.first_row
                  else [self._pos0()])

        def put_slot(pos, slot):
            rec = per[pos]
            for dt, f in slot.flops.items():
                rec["dot_flops"][dt] = rec["dot_flops"].get(dt, 0) + f
            for name, k in slot.kernels.items():
                got = rec["kernels"].setdefault(
                    name, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                           "dtype": k["dtype"]})
                for f in ("launches", "flops", "bytes"):
                    got[f] += k[f]
            rec["temp_bytes"] = max(rec["temp_bytes"], slot.peak)

        put_slot(self._pos0(), self.slots[0])
        for slot in row_slots:
            for by in shifts:
                put_slot(self._shift(slot.pos, by), slot)
        merged = collections.Counter(
            (kind_, nb, scale, srcs, dst, row is not None)
            for kind_, nb, scale, srcs, dst, row in self.events)
        for (kind_, nb, scale, srcs, dst, of_row), k in merged.items():
            moves = shifts if (of_row and self.first_row) else [self._pos0()]
            for by in moves:
                d = dst if kind_ in FIXED_DST else self._shift(dst, by)
                src = [self._shift(s, by) for s in srcs]
                if all(s == d for s in src):
                    continue
                inter = any(self._node(s) != self._node(d) for s in src)
                c = per[d]["collectives"].setdefault(
                    kind_, {"count": 0, "bytes": 0, "inter_node_bytes": 0})
                c["count"] += k * scale
                c["bytes"] += k * nb * scale
                c["inter_node_bytes"] += k * nb * scale if inter else 0
        rows = []
        for p in positions:
            rec = per[p]
            coll = rec["collectives"]
            arg, outb = self.args.get(p, 0), self.outs.get(p, 0)
            rows.append({
                "pos": list(p), "argument_bytes": arg, "output_bytes": outb,
                "temp_bytes": rec["temp_bytes"], "alias_bytes": 0,
                "peak_device_bytes": arg + outb + rec["temp_bytes"],
                "dot_flops_by_dtype": rec["dot_flops"],
                "dot_flops": sum(rec["dot_flops"].values()),
                "kernels": rec["kernels"],
                "kernel_flops": sum(k["flops"] for k in
                                    rec["kernels"].values()),
                "kernel_bytes": sum(k["bytes"] for k in
                                    rec["kernels"].values()),
                "collectives": coll,
                "collective_bytes_total": sum(c["bytes"]
                                              for c in coll.values()),
                "inter_node_bytes": sum(c["inter_node_bytes"]
                                        for c in coll.values())})
        self.record = analyze(rows)
        if self.one_device:
            self.record["device_peak_bytes"] = self.dev_peak
        self.record["rows_traced"] = {
            "rows": 1 if self.first_row else n_rows, "of_rows": n_rows,
            "microbatches": 1 if self.first_row else self.micro,
            "of_microbatches": self.micro,
            "note": ("row 0's first microbatch, scaled by the microbatches "
                     "and given to every data row's position, its copies "
                     "translated along the data axes") if self.first_row
            else "every row and microbatch traced"}
        return self.record


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _locals(tree):
    for leaf in _leaves(tree):
        if isinstance(leaf, shd.ShardedTensor):
            for pos in leaf.sharding.positions():
                yield leaf.local(pos)
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def analyze(positions: list) -> dict:
    """The step's figures from its positions' (``Account.finish``): each
    per-device figure is the maximum over positions, with the position it
    is taken at (``max_at``); ``loop_aware`` keeps the reference's keys
    for ``launch.roofline``.  The port's twin of the reference's
    ``analyze(hlo)``."""
    def top(key):
        return max(positions, key=lambda r: r[key])

    mem, flop, coll = (top("peak_device_bytes"), top("dot_flops"),
                       top("collective_bytes_total"))
    return {
        "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes", "alias_bytes",
                                       "peak_device_bytes")},
        "cost": {"flops": flop["dot_flops"] + flop["kernel_flops"]},
        "loop_aware": {"dot_flops": flop["dot_flops"],
                       "dot_flops_by_dtype": flop["dot_flops_by_dtype"],
                       "kernel_flops": flop["kernel_flops"],
                       "kernel_bytes": flop["kernel_bytes"],
                       "collectives": coll["collectives"],
                       "collective_bytes_total":
                           coll["collective_bytes_total"]},
        "collectives": coll["collectives"],
        "collective_bytes_total": coll["collective_bytes_total"],
        "kernels": flop["kernels"],
        "max_at": {"peak_device_bytes": mem["pos"], "dot_flops": flop["pos"],
                   "collective_bytes_total": coll["pos"]},
        "positions": positions,
    }
