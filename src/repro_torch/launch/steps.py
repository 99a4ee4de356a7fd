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
enc_len, d_model).

Over a mesh (parameters and moments ``distributed.sharding.ShardedTensor``
leaves, as ``train_specs`` lays them out), ``build_train_step`` runs the
sharded step (``sharded_loss_and_grads``): one thread and, on a card, one
CUDA stream per data row, each on its rows of the batch — each of the
row's positions computing its ``model`` share with its block of every
layer (``models.tensor_parallel``; the SSM's and hybrid's heads in
``models.tensor_parallel_ssm``), a row of one position computing layers
gathered whole — and each
layer's gradient added into the gradient blocks, one a position, in row
order; then ``adam.update`` block by block.  ``build_prefill_step`` and
``build_decode_step`` serve over a mesh the same way (``sharded_prefill``,
``sharded_decode``): a thread and CUDA stream a data row on its batch
rows, the cache a tree of ``ShardedTensor`` laid out by the family's
``cache_axes`` — read and written by each position where it lies
(tensor-parallel), or read from and written back into by the row
(``sharding.RowCache``).

``train_specs``, ``prefill_specs`` and ``decode_specs`` give each step's
meta-device arguments and shardings, the twins of the reference's;
``lower_cell`` runs a cell's step on them under the account of
``launch.hlo_analysis`` (the dry-run, ``launch.dryrun``).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed import sharding as shd
from ..models import tensor_parallel as TP
from ..models import zoo
from ..models.layers import dtype_of
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


def is_sharded(params) -> bool:
    """Whether ``params`` is laid out on a mesh (``ShardedTensor`` leaves)."""
    return isinstance(next(adam.leaves(params))[1], shd.ShardedTensor)


def _mesh_of(params):
    """The mesh a tree of ``ShardedTensor`` parameters is laid out on."""
    return next(adam.leaves(params))[1].sharding.mesh


_ROW_STREAMS: dict = {}


def _row_stream(dev, r):
    key = (dev, r)
    if key not in _ROW_STREAMS:
        _ROW_STREAMS[key] = torch.cuda.Stream(dev)
    return _ROW_STREAMS[key]


def drive_rows(devices, body):
    """``body(r)`` for every data row r, on a thread each (one row runs on
    the calling thread); on a card under the row's device and a CUDA
    stream of its own on each device of the row (``devices[r]``: a device,
    or a list of them, the row's first) that first waits for the caller's
    stream there, which waits for every row's streams once all are joined.
    The first error is re-raised."""
    devices = [d if isinstance(d, (list, tuple)) else [d] for d in devices]
    cards = {d for ds in devices for d in ds if d.type == "cuda"}
    callers = {d: torch.cuda.current_stream(d) for d in cards}
    done = []

    def drive(r):
        dev = devices[r][0]
        if dev.type != "cuda":
            body(r)
            return
        with contextlib.ExitStack() as stack:
            for d in dict.fromkeys(devices[r]):
                stream = _row_stream(d, r)
                stream.wait_stream(callers[d])
                done.append((d, stream))
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.cuda.device(dev))
            body(r)

    errors = []
    if len(devices) == 1:
        try:
            drive(0)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
    else:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(devices),
                thread_name_prefix="train-row") as pool:
            futures = [pool.submit(drive, r) for r in range(len(devices))]
            errors = [f.exception() for f in futures]
    for d, stream in done:
        callers[d].wait_stream(stream)
    errors = [e for e in errors if e is not None]
    # a row that failed breaks the others' barrier: raise its error
    errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
    if errors:
        raise errors[0]


def _row_batch(batch: dict, mesh, row, accum: int = 1) -> dict:
    """Data row ``row``'s rows of every input on its device, microbatch by
    microbatch — the train step's and the serving steps' one rule: of each
    of the ``accum`` microbatches one device would take (B/accum rows
    each, in order) the row's block where the microbatch splits evenly
    over the data rows (``pod`` × ``data``), and the whole microbatch
    where it does not (``sharding.row_rows``: the reference replicates a
    batch dimension that does not divide the data axis, so every row
    computes it).  A microbatch over the rows is then one device's, once
    or on every row.  A sharded input's local block is taken as it is
    where it holds exactly those rows; else the whole input is gathered
    first (an all-gather to the row's position), once a step."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % accum:
            raise ValueError(f"{k}: a batch of {B} rows does not reshape "
                             f"into grad_accum={accum} microbatches")
        m = B // accum
        span = shd.row_rows(mesh, m, row.pos)
        want = [slice(i * m + span.start, i * m + span.stop)
                for i in range(accum)]
        if isinstance(v, shd.ShardedTensor):
            sl, local = v.sharding.slices(v.shape, row.pos), v.local(row.pos)
            joined = all(a.stop == b.start for a, b in zip(want, want[1:]))
            if joined and sl[0] == slice(want[0].start, want[-1].stop) and \
                    local.device == row.device and all(
                        s == slice(0, d) for s, d in zip(sl[1:], v.shape[1:])):
                out[k] = local
                continue
            shd.note("all-gather", v.numel() * v.dtype.itemsize,
                     [p for p, _ in v.block_slices()], row.pos, row.index)
            v = v.full(row.device)
        out[k] = v[want[0]].to(row.device) if accum == 1 else \
            torch.cat([v[w] for w in want]).to(row.device)
    return out


def _grad_tree(params: dict, blocks: dict) -> dict:
    """The gradients as a tree of ``ShardedTensor`` in the parameters'
    layout from ``blocks`` (``RowGroup.grads``: each position's one block
    of every leaf): a position holding a copy of a block takes the first
    copy's tensor, or a copy of it on another device (a copy between
    positions, which the account counts).  A zero-length leaf no loss
    reached gets its empty gradient; any other leaf raises."""
    missing = []

    def leaf(name, p):
        acc = blocks.get(name)
        if acc is None:
            if p.numel():
                missing.append(name)
            return p.map(torch.zeros_like)
        sh = p.sharding
        out = np.empty(p.shards.shape, dtype=object)
        for pos in sh.positions():
            first = sh.first_copy(pos)
            blk, dev = acc[first], sh.device(pos)
            out[pos] = blk if blk.device == dev else blk.to(dev)
            if first != pos:
                shd.note("broadcast", blk.nbytes, [first], pos)
        return shd.ShardedTensor(out, sh, p.shape, p.dtype)

    grads = zoo.tree_map(leaf, params)
    if missing:
        raise RuntimeError(f"the loss reached no gradient of {missing}")
    return grads


def _param_axes(model: zoo.Model) -> dict:
    """The parameters' logical axes (from meta shapes, which hold no
    device memory: not an account's temporaries)."""
    with shd.untracked(on_device=False):
        return model.abstract_params()[1]


def _first_row_only() -> bool:
    """Whether a traced step runs its first data row and first microbatch
    alone (``launch.hlo_analysis``: every row has the same shapes)."""
    acc = shd.ACCOUNT
    return acc is not None and acc.first_row


def _row_devices(row) -> list:
    """The devices a data row's thread issues work on: its own first."""
    return [row.device] + [d for d in row.devices if d != row.device]


def _count(micro: dict, i: int, by_mask: bool = True) -> float:
    """What a row's microbatch ``i`` weighs in the mean: its ``loss_mask``
    tokens where the batch carries one (and ``by_mask``), else its rows —
    its share of the tokens, every row being as long."""
    if by_mask and "loss_mask" in micro:
        return float(micro["loss_mask"][i].float().sum())
    return float(micro["tokens"].shape[1])


def _weights(counts: list) -> list:
    """The rows' weights in one microbatch's mean from their ``counts``
    (equal where nothing counts: every loss is then 0)."""
    total = sum(counts)
    return [c / total if total else 1.0 / len(counts) for c in counts]


def row_grads(model: zoo.Model, params: dict, batch: dict):
    """The data rows' part of ``sharded_loss_and_grads``: (blocks, loss),
    ``blocks`` the step's gradient blocks (``RowGroup.grads``: each
    position's one block of every leaf it was gathered from, the rows'
    parts weighted and added in row order) and ``loss`` the global
    batch's.  Row r's part of microbatch i weighs its share of the rows
    (or ``loss_mask`` tokens) of the rows' parts of that microbatch, over
    ``grad_accum`` — the mean of the microbatches' means, as one device
    takes it; where every row computes a microbatch whole, each weighs
    1/n_rows, so it is counted once.  A MoE's load-balancing term is a
    mean over every token, masked or not: it weighs the row's share of the
    rows, w_t, and the cross-entropy its share of the mask, w_x (the
    forward hands the two apart).  The row's backward runs on
    (w_x / w_t) · xent + balance with its gradient parts weighed w_t —
    w_t is never 0, so a row whose mask is empty still adds its gates'
    part — and where the two shares are equal, as without a mask, that is
    the loss as the forward sums it.  A step traced on its first row
    alone runs row 0's first microbatch only, weighting the rows
    equally."""
    mesh = _mesh_of(params)
    axes = _param_axes(model)
    alone = _first_row_only()
    rows = shd.mesh_rows(mesh, run=1 if alone else None)
    n_rows = len(rows)
    run = rows[:1] if alone else rows
    accum = max(1, model.cfg.grad_accum)
    parts = [_row_batch(batch, mesh, row, accum) for row in run]
    micro = [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
              for k, v in part.items()} for part in parts]

    def shares(by_mask):
        if alone:
            return [[1.0 / n_rows] * n_rows]
        return [_weights([_count(mb, i, by_mask) for mb in micro])
                for i in range(accum)]
    moe = bool(model.cfg.n_experts)
    w_x = shares(True)
    w_t = shares(False) if moe else w_x
    losses = [None] * n_rows
    group = rows[0].group
    tp = TP.active(model.cfg, rows[0])
    kw = {"terms": True} if moe else {}
    forward = (lambda p, b: TP.forward(model.cfg, p, b, **kw)) if tp else \
        (lambda p, b: model.forward(p, b, **kw))

    def body(r):
        row = rows[r]
        total = 0.0
        try:
            with shd.row_scope(row):
                for i in range(1 if alone else accum):
                    # set before the row's backward adds a part with it
                    group.weights[r] = w_t[i][r] / accum
                    # aux: a MoE's balance term, else the metrics
                    loss, aux = forward(
                        shd.bind_row(params, axes, row, whole=not tp),
                        {k: v[i] for k, v in micro[r].items()})
                    if moe:
                        loss = (w_x[i][r] / w_t[i][r]) * loss + aux
                    with shd.backward_scope(row):
                        loss.backward()
                    total = total + w_t[i][r] * loss.detach()
        except BaseException:
            group.abort()
            raise
        losses[r] = total / accum

    drive_rows([_row_devices(row) for row in run], body)
    group.check_done()
    loss = sum(lo.to(rows[0].device) for lo in losses if lo is not None)
    return group.grads, loss


def sharded_loss_and_grads(model: zoo.Model, params: dict, batch: dict):
    """``loss_and_grads`` over the mesh ``params`` are laid out on: (loss,
    metrics, grads), grads a tree of ``ShardedTensor`` in the parameters'
    layout.

    Each of the ``cfg.grad_accum`` microbatches (B/grad_accum rows; a
    batch that does not reshape into them raises) splits evenly over the
    data rows (``pod`` × ``data``) where it can, and is computed whole by
    every row where it cannot, as the reference's GSPMD step replicates a
    batch dimension that does not divide the data axis
    (``_row_batch``, the serving steps' rule too).  Row r is a thread, on
    a CUDA stream of its own on each of its devices, that runs
    ``cfg.grad_accum`` microbatches of its rows in order, each a forward
    over ``sharding.bind_row``'s view of the parameters — for a
    tensor-parallel family (``models.tensor_parallel``) each of its
    positions computing its ``model`` share with its block of every layer,
    else the row's device computing whole layers — and a ``backward()``
    that adds each gathered layer's gradient into the gradient blocks of
    the positions it was gathered from (``row_grads``).  Row r's
    microbatch i is its share of one device's microbatch i, its block or
    all of it (``_row_batch``), and a MoE layer's load-balancing term
    takes the first-choice shares of all rows' tokens
    (``sharding.Row.gather_sum``, where the rows wait for one another in
    the forward; where the rows replicate a microbatch both of its sums
    grow n_rows-fold and their ratio is one device's), so a microbatch
    over the rows computes what one device's does.  The rows' parts are
    weighted so the result is the gradient of the mean over the global
    batch — by rows, or by the ``loss_mask`` tokens when the batch carries
    one (a MoE's balance term by rows whatever the mask), a replicated
    microbatch 1/n_rows on each row — which is the loss returned, and
    added in row order: a position holds one gradient block a leaf, never
    a whole leaf's gradient."""
    blocks, loss = row_grads(model, params, batch)
    grads = _grad_tree(params, blocks)
    return loss, {"loss": loss}, grads


def build_train_step(model: zoo.Model,
                     opt_cfg: adam.AdamConfig = adam.AdamConfig()):
    """(params, opt_state, batch) -> (params', opt_state', metrics), metrics
    ``loss`` and ``grad_norm``: ``loss_and_grads`` (``sharded_loss_and_grads``
    over a mesh) then ``adam.update``, which writes the parameters and
    moments in place; the gradients are released after the update."""
    def train_step(params, opt_state, batch):
        if is_sharded(params):
            _, metrics, grads = sharded_loss_and_grads(model, params, batch)
            new_params, new_opt, opt_metrics = adam.update(
                grads, opt_state, params, opt_cfg)
            del grads
            return new_params, new_opt, dict(metrics, **opt_metrics)
        _, metrics, grads = loss_and_grads(model, params, batch)
        new_params, new_opt, opt_metrics = adam.update(
            grads, opt_state, params, opt_cfg)
        del grads
        for _, p in zoo.flatten(params):
            p.grad = None
        return new_params, new_opt, dict(metrics, **opt_metrics)
    return train_step


def train_specs(model: zoo.Model, shape: ShapeSpec, mesh,
                opt_cfg: adam.AdamConfig = adam.AdamConfig()):
    """Meta-device arguments and shardings of the train step on ``mesh``:
    the twin of the reference's ``train_specs``, ``args`` (params, opt
    state, batch) and ``in_shardings`` / ``out_shardings`` trees of
    ``NamedSharding`` resolved from the parameters' logical axes."""
    p_shapes, p_axes = model.abstract_params()
    opt_shapes = adam.init(p_shapes, opt_cfg)
    opt_axes = adam.opt_state_axes(p_axes)
    spec = zoo.input_specs(model.cfg, shape)
    assert spec["kind"] == "train"
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    o_sh = shd.tree_shardings(opt_axes, opt_shapes, mesh)
    b_sh = shd.tree_shardings(spec["axes"], spec["batch"], mesh)
    metrics_sh = {k: shd.sharding_for("", (), mesh)
                  for k in ("loss", "grad_norm")}
    return dict(args=(p_shapes, opt_shapes, spec["batch"]),
                in_shardings=(p_sh, o_sh, b_sh),
                out_shardings=(p_sh, o_sh, metrics_sh),
                donate_argnums=(0, 1))


def serving_model(cfg: ArchConfig, *, serve_dtype: str = "bfloat16",
                  device=None) -> zoo.Model:
    """The model of cfg with every parameter in ``serve_dtype``: the
    reference's ``_bf16_init`` (``lower_cell``'s serving parameters) in
    one call, since the port's ``init`` draws in ``cfg.param_dtype``."""
    return zoo.build(dataclasses.replace(cfg, param_dtype=serve_dtype), device)


def _serve_rows(mesh, body):
    """``body(row)`` for every data row of ``mesh`` (the first alone in a
    traced step), each under no autograd and the account's row scope."""
    alone = _first_row_only()
    run = shd.mesh_rows(mesh, run=1 if alone else None)[:1 if alone else None]

    def drive(r):
        with torch.no_grad(), shd.row_scope(run[r]):
            body(run[r])
    drive_rows([_row_devices(row) for row in run], drive)


def _write_logits(logits: shd.ShardedTensor, row, span: slice, lg):
    """A row's logits into their positions' blocks: one tensor, the row's
    whole vocab, into every position it owns; or (a tensor-parallel
    step's) each position's over its vocab block into that position's
    block, where it lies (position 0's alone where the vocab is not
    split, into every owned block)."""
    out = shd.RowCache(logits, row, 0, span, kind="output")
    if isinstance(lg, torch.Tensor):
        out.copy_(lg)
        return
    for j, t in enumerate(lg):
        if t is None:
            continue
        if lg.count(None):
            out.put((), t, src=row.tp[j])
            continue
        vocab = logits.sharding.slices(logits.shape, row.tp[j])[2]
        out.put((slice(None), slice(None), vocab), t, src=row.tp[j])


def _logits_out(model: zoo.Model, mesh, B: int) -> shd.ShardedTensor:
    """Zeros for the step's logits, laid out on ``batch|seq|vocab``."""
    shape = (B, 1, model.cfg.vocab)
    with shd.untracked():
        return shd.zeros(shape, dtype_of(model.cfg.dtype),
                         shd.sharding_for("batch|seq|vocab", shape, mesh))


def cache_shapes(model: zoo.Model, batch: dict, max_len: int) -> dict:
    """Meta tensors of the cache a prefill of ``batch`` fills: the
    reference's ``abstract_cache``, an enc-dec's cross K/V sized by the
    frames it encodes."""
    B = batch["tokens"].shape[0]
    if model.cfg.family == "encdec":
        return model.module.init_cache(model.cfg, B, max_len, "meta",
                                       enc_len=batch["frames"].shape[1])
    return model.abstract_cache(B, max_len)


def sharded_prefill(model: zoo.Model, params: dict, batch: dict,
                    max_len: int, *, attn_impl: str = "auto"):
    """``model.prefill`` over the mesh ``params`` are laid out on: (cache,
    logits), the cache a tree of ``ShardedTensor`` laid out by
    ``model.cache_axes()`` and the last position's logits on
    ``batch|seq|vocab``.  Each data row runs on its thread and CUDA stream
    (``drive_rows``) over its batch rows (``sharding.row_rows``: every row
    computes a batch that does not split, as the reference replicates
    it) — for a tensor-parallel family each of its positions computing its
    ``model`` share (``models.tensor_parallel.prefill``, its K/V — an
    enc-dec's cross K/V too — moved into the cache's blocks, split by
    sequence or by heads), else the row gathering whole
    layers one at a time (``bind_row`` / ``hint_tree``) — and writes each
    layer's cache and its logits into the blocks of the positions it owns
    (``sharding.RowCache``; each position's logits over its vocab block
    straight into its own)."""
    mesh = _mesh_of(params)
    c_axes = model.cache_axes()
    with shd.untracked(on_device=False):
        shapes = cache_shapes(model, batch, max_len)
    with shd.untracked():
        cache = shd.tree_map(
            lambda t, sh: shd.zeros(tuple(t.shape), t.dtype, sh), shapes,
            shd.tree_shardings(c_axes, shapes, mesh))
    B = batch["tokens"].shape[0]
    logits = _logits_out(model, mesh, B)
    p_axes = _param_axes(model)

    def body(row):
        span = shd.row_rows(mesh, B, row.pos)
        rc = shd.bind_cache(cache, c_axes, row, span)
        part = _row_batch(batch, mesh, row)
        if TP.serves(model.cfg, row, rc):
            _, lg = TP.prefill(model.cfg,
                               shd.bind_row(params, p_axes, row, whole=False),
                               part, max_len, attn_impl=attn_impl, cache=rc)
        else:
            _, lg = model.prefill(shd.bind_row(params, p_axes, row), part,
                                  max_len, attn_impl=attn_impl, cache=rc)
        _write_logits(logits, row, span, lg)

    _serve_rows(mesh, body)
    S = batch["tokens"].shape[1]
    if "patch_embs" in batch:
        S += batch["patch_embs"].shape[1]
    for pos in cache["len"].sharding.positions():
        cache["len"].local(pos).fill_(S)
    return cache, logits


def sharded_decode(model: zoo.Model, params: dict, cache: dict, token):
    """``model.decode`` over the mesh ``params`` are laid out on: (cache,
    logits).  For a tensor-parallel family each of a data row's positions
    reads and writes its own cache block only
    (``models.tensor_parallel.decode``); else each data row reads its
    batch rows of a layer's cache from the positions holding them, decodes
    them (``bind_row`` gathers the layer) and writes what it changed back
    into its positions' blocks in place — the token's K/V at ``len`` (a
    masked ``index_copy_`` into every owned block), the SSM state and conv
    window whole.  The cache returned holds the same blocks and ``len`` +
    1 on every position."""
    mesh = _mesh_of(params)
    c_axes = model.cache_axes()
    B = token.shape[0]
    logits = _logits_out(model, mesh, B)
    p_axes = _param_axes(model)

    def body(row):
        span = shd.row_rows(mesh, B, row.pos)
        tok = _row_batch({"token": token}, mesh, row)["token"]
        rc = shd.bind_cache(cache, c_axes, row, span)
        if TP.serves(model.cfg, row, rc):
            _, lg = TP.decode(model.cfg,
                              shd.bind_row(params, p_axes, row, whole=False),
                              rc, tok)
        else:
            _, lg = model.decode(shd.bind_row(params, p_axes, row), rc, tok)
        _write_logits(logits, row, span, lg)

    _serve_rows(mesh, body)
    with shd.untracked():
        return dict(cache, len=cache["len"].map(lambda t: t + 1)), logits


def build_prefill_step(model: zoo.Model, max_len: int, *,
                       attn_impl: str = "auto"):
    """(params, batch) -> (cache, last-position logits); batch: tokens
    (B, S) [, patch_embs (B, P, d) | frames (B, enc_len, d)].  Over a mesh
    (``ShardedTensor`` parameters) ``sharded_prefill``."""
    def prefill_step(params, batch):
        if is_sharded(params):
            return sharded_prefill(model, params, batch, max_len,
                                   attn_impl=attn_impl)
        with torch.no_grad():
            return model.prefill(params, batch, max_len, attn_impl=attn_impl)
    return prefill_step


def build_decode_step(model: zoo.Model):
    """(params, cache, token) -> (cache, logits).  Over a mesh
    ``sharded_decode``."""
    def decode_step(params, cache, token):
        if is_sharded(params):
            return sharded_decode(model, params, cache, token)
        with torch.no_grad():
            return model.decode(params, cache, token)
    return decode_step


def prefill_specs(model: zoo.Model, shape: ShapeSpec, mesh):
    """Meta-device arguments and shardings of the prefill step on
    ``mesh``, the twin of the reference's: ``args`` (params, batch),
    ``out_shardings`` (the cache laid out by ``cache_axes``, the logits on
    ``batch|seq|vocab``) and ``max_len``."""
    p_shapes, p_axes = model.abstract_params()
    spec = zoo.input_specs(model.cfg, shape)
    assert spec["kind"] == "prefill"
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    b_sh = shd.tree_shardings(spec["axes"], spec["batch"], mesh)
    cache_shapes_ = model.abstract_cache(shape.global_batch, spec["max_len"])
    cache_sh = shd.tree_shardings(model.cache_axes(), cache_shapes_, mesh)
    B = shape.global_batch
    logits_sh = shd.sharding_for("batch|seq|vocab", (B, 1, model.cfg.vocab),
                                 mesh)
    return dict(args=(p_shapes, spec["batch"]),
                in_shardings=(p_sh, b_sh),
                out_shardings=(cache_sh, logits_sh),
                max_len=spec["max_len"], donate_argnums=())


def decode_specs(model: zoo.Model, shape: ShapeSpec, mesh):
    """Meta-device arguments and shardings of the decode step on ``mesh``,
    the twin of the reference's: ``args`` (params, cache, token), the
    cache in and out laid out by ``cache_axes``.  Call it under
    ``sharding.serve_mode()`` for weights-resident serving."""
    p_shapes, p_axes = model.abstract_params()
    spec = zoo.input_specs(model.cfg, shape)
    assert spec["kind"] == "decode"
    B, max_len = spec["cache_batch"], spec["max_len"]
    c_shapes = model.abstract_cache(B, max_len)
    cache_sh = shd.tree_shardings(model.cache_axes(), c_shapes, mesh)
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    tok_sh = shd.sharding_for("batch|seq", (B, 1), mesh)
    logits_sh = shd.sharding_for("batch|seq|vocab", (B, 1, model.cfg.vocab),
                                 mesh)
    return dict(args=(p_shapes, c_shapes, spec["batch"]["token"]),
                in_shardings=(p_sh, cache_sh, tok_sh),
                out_shardings=(cache_sh, logits_sh),
                donate_argnums=(1,))


def cell_specs(model: zoo.Model, shape: ShapeSpec, mesh, *,
               serve_dtype: str = "bfloat16"):
    """(the model the cell runs, its specs, its step) for one (arch ×
    shape) cell on ``mesh``: ``train_specs`` and the train step, or — with
    ``serve_dtype`` parameters (``serving_model``) — ``prefill_specs`` or,
    under ``sharding.serve_mode()`` where ``cfg.serve_weights_resident``,
    ``decode_specs``, as the reference's ``lower_cell`` picks them."""
    cfg = model.cfg
    if shape.kind == "train":
        return model, train_specs(model, shape, mesh), build_train_step(model)
    smodel = serving_model(cfg, serve_dtype=serve_dtype, device=model.device)
    if shape.kind == "prefill":
        sp = prefill_specs(smodel, shape, mesh)
        return smodel, sp, build_prefill_step(smodel, sp["max_len"])
    ctx = (shd.serve_mode() if cfg.serve_weights_resident
           else contextlib.nullcontext())
    with ctx:
        sp = decode_specs(smodel, shape, mesh)
    return smodel, sp, build_decode_step(smodel)


def lower_cell(model: zoo.Model, shape: ShapeSpec, mesh, *,
               serve_dtype: str = "bfloat16", every_row: bool = False,
               one_device: bool = False):
    """The account of one (arch × shape) cell on ``mesh`` — the port's
    counterpart of the reference's lowering: the cell's meta arguments
    (``cell_specs``) laid out by their shardings with ``place_tree``, its
    step run once on them under a ``launch.hlo_analysis.Account``, which is
    returned with its record made.  ``mesh`` is a mesh of ``meta`` devices
    (``launch.mesh.make_production_mesh(device="meta")``).  By default the
    step runs its first data row and first microbatch alone and the
    account scales them (every row has the same shapes); ``every_row``
    runs them all.  ``one_device`` accounts for a mesh whose positions
    share one card as well (``hlo_analysis.Account``'s ``one_device``)."""
    from . import hlo_analysis
    smodel, sp, step = cell_specs(model, shape, mesh, serve_dtype=serve_dtype)
    args = tuple(shd.place_tree(a, sh) if isinstance(a, dict) else
                 shd.place(a, sh)
                 for a, sh in zip(sp["args"], sp["in_shardings"]))
    acc = hlo_analysis.Account(
        mesh, first_row=not (every_row or one_device), one_device=one_device,
        micro=max(1, smodel.cfg.grad_accum) if shape.kind == "train" else 1)
    acc.lay_out(args)
    with acc:
        out = step(*args)
    acc.finish(out, shape.kind)
    return acc
