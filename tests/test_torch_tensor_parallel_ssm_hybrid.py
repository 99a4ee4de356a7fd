"""Tensor-parallel compute over ``model`` for the SSM and hybrid families
(the port's ``models.tensor_parallel_ssm``), held against the reference's
GSPMD step and against the port's own one-device step.

* The reference's sharded steps: one subprocess (XLA's forced host device
  count must be set before JAX starts) runs, for reduced mamba2-1.3b,
  reduced zamba2-7b at 3 layers (a group of two SSM layers, the shared
  block, a tail of one) and mamba2 at 130 tokens (across a chunk
  boundary: the scan's pad path, served only — see ``CASES``),
  ``value_and_grad`` of the forward, the prefill and two decode steps,
  each ``jax.jit`` with the reference's
  shardings over ``make_host_mesh(4, model=2)`` under ``use_mesh``; the
  port runs the same parameters (``zoo.params_from_numpy``) over a (2, 2)
  mesh of repeated CPU devices, each position computing its ``model``
  share — the reduced configs' 552 ``in_proj`` columns cut at 276, so z
  and x straddle the cut as the full configs' do at 16: the loss within
  1e-5 relative and every gradient leaf within 1e-5 of its largest entry,
  the logits and every cache leaf (conv, state, K/V) within 1e-4 of the
  largest.
* The port's one-device steps: the same within 1e-5, and the fallthrough
  where the heads do not divide ``model`` (d_model 96, head dim 64: 3
  heads, 419 ``in_proj`` columns): every position computes all heads.
* The layout: a traced decode cell of each family gathers no parameter
  and copies no cache block between positions, each conv and state block
  written only through its own position's view; after a train step each
  position holds one gradient block a leaf (the hybrid's shared block
  included), and two runs are equal bit for bit.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import tensor_parallel_ssm as TPS
from repro_torch.models import transformer, zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name -> (config, overrides of the reduced config, prompt tokens, train
#: tokens or None).  The 130-token case is served only: a training
#: sequence of 128 tokens or more fills a chunk whose summed dt·exp(A_log)
#: passes float32's exp range at these weights, where the reference's
#: gradient is NaN (ROADMAP §C) and the f32 gradients of A_log and
#: dt_bias reach the float32 floor that chip_smoke's s3 measures.
CASES = {"mamba2-1.3b": ("mamba2-1.3b", {}, 24, 24),
         "zamba2-7b": ("zamba2-7b", {"n_layers": 3}, 24, 24),
         "mamba2-1.3b:130": ("mamba2-1.3b", {}, 130, None)}
TRAINED = sorted(k for k, v in CASES.items() if v[3])
B, EXTRA, TRAIN_ROWS = 4, 4, 8         # prompts, max_len room, train rows

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses, json
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config, reduced_for_smoke
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.models import zoo
    from repro.models.base import tree_unbox

    cases, B, extra, rows, out = json.loads(sys.argv[1])
    mesh = make_host_mesh(4, model=2)
    res = {}

    def flat(tree, prefix):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(str(k.key) for k in path)
            res[f"{prefix}:{name}"] = np.asarray(v, np.float32)

    def shardings(axes, tree):
        return jax.tree_util.tree_map(
            lambda ax, t: shd.sharding_for(ax, t.shape, mesh), axes, tree)

    for name, (arch, over, S, T) in cases.items():
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                                  grad_accum=1, **over)
        model = zoo.build(cfg)
        params, axes = tree_unbox(model.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(11)
        batch = {k: rng.integers(0, cfg.vocab, (rows, T or S))
                 .astype(np.int32) for k in ("tokens", "labels")}
        flat(params, f"{name}:params")
        for k, v in batch.items():
            res[f"{name}:batch:{k}"] = v
        b_sh = {k: shd.sharding_for("batch|seq", v.shape, mesh)
                for k, v in batch.items()}
        if T:
            with shd.use_mesh(mesh):
                p_sh = shardings(axes, params)
                grad = jax.jit(jax.value_and_grad(
                    lambda p, b: model.forward(p, b)[0]),
                    in_shardings=(p_sh, b_sh))
                loss, g = grad(jax.device_put(params, p_sh),
                               jax.device_put({k: jnp.asarray(v) for k, v
                                               in batch.items()}, b_sh))
            res[f"{name}:loss"] = np.asarray(loss)
            flat(g, f"{name}:grad")
        prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                for _ in range(2)]
        res[f"{name}:batch:prompt_tokens"] = prompt
        for i, t in enumerate(toks):
            res[f"{name}:batch:token{i}"] = t
        max_len = S + extra
        with shd.use_mesh(mesh):
            p_sh = shardings(axes, params)
            c_shapes = model.abstract_cache(B, max_len)
            c_sh = shardings(model.cache_axes(), c_shapes)
            l_sh = shd.sharding_for("batch|seq|vocab", (B, 1, cfg.vocab),
                                    mesh)
            pr_sh = {"tokens": shd.sharding_for("batch|seq", prompt.shape,
                                                mesh)}
            pre = jax.jit(lambda p, b: model.prefill(p, b, max_len),
                          in_shardings=(p_sh, pr_sh),
                          out_shardings=(c_sh, l_sh))
            cache, lg = pre(params, {"tokens": jnp.asarray(prompt)})
            flat(cache, f"{name}:cache0")
            res[f"{name}:logits0"] = np.asarray(lg)
        with shd.use_mesh(mesh), shd.serve_mode():
            d_sh = shardings(axes, params)
            c_sh = shardings(model.cache_axes(), c_shapes)
            t_sh = shd.sharding_for("batch|seq", (B, 1), mesh)
            dec = jax.jit(lambda p, c, t: model.decode(p, c, t),
                          in_shardings=(d_sh, c_sh, t_sh),
                          out_shardings=(c_sh, l_sh))
            for i, t in enumerate(toks):
                cache, lg = dec(params, cache, jnp.asarray(t))
                res[f"{name}:logits{i + 1}"] = np.asarray(lg)
            flat(cache, f"{name}:cache2")
    np.savez(out, **res)
    print(json.dumps({"ok": True}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case of ``CASES`` (one
    subprocess), keyed ``case:what[:leaf]``."""
    out = str(tmp_path_factory.mktemp("tpssm") / "ref.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    arg = [CASES, B, EXTRA, TRAIN_ROWS, out]
    proc = subprocess.run([sys.executable, "-c", _REF, json.dumps(arg)],
                          capture_output=True, text=True, env=env,
                          timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        return dict(f.items())


def _cpu_mesh(shape, device="cpu"):
    return Mesh(np.array([torch.device(device)] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _unflat(d: dict) -> dict:
    out = {}
    for name, v in d.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _cfg(arch, over):
    return dataclasses.replace(reduced_for_smoke(get_config(arch)),
                               grad_accum=1, **over)


def _case(ref, name):
    """(cfg, port parameters, train batch or None, prompt, decode tokens,
    prompt length) of case ``name`` from the reference's run."""
    arch, over, S, T = CASES[name]
    cfg = _cfg(arch, over)
    pre = f"{name}:params:"
    tree = _unflat({k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)})
    params = zoo.params_from_numpy(cfg, tree, "cpu")

    def get(k):
        return torch.from_numpy(ref[f"{name}:batch:{k}"])
    batch = {k: get(k) for k in ("tokens", "labels")} if T else None
    return (cfg, params, batch, {"tokens": get("prompt_tokens")},
            [get("token0"), get("token1")], S)


def _own_case(name, over=None, S=24):
    """(cfg, parameters drawn by the port, train batch, prompt, tokens,
    prompt length) of ``name`` (a config id) with ``over`` its reduced
    config's overrides."""
    cfg = _cfg(name, over or {})
    model = zoo.build(cfg, "cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN_ROWS, S))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                             .astype(np.int32)) for _ in range(2)]
    return cfg, model.init(0), batch, {"tokens": batch["tokens"][:B]}, \
        toks, S


def _sharded(model, params, mesh_shape):
    shapes, axes = model.abstract_params()
    return shd.place_tree(params, shd.tree_shardings(
        axes, shapes, _cpu_mesh(mesh_shape)))


def _serve(model, params, prompt, toks, S):
    """(every step's logits, the cache after the prefill, the final cache)
    as numpy, of the prefill and a decode step a token."""
    def np_of(t):                     # a one-device decode writes in place
        return t.numpy() if isinstance(t, shd.ShardedTensor) else \
            t.detach().numpy().copy()
    pre = steps.build_prefill_step(model, S + EXTRA)
    dec = steps.build_decode_step(model)
    cache, lg = pre(params, prompt)
    logits = [np_of(lg)]
    first = {k: np_of(v) for k, v in zoo.flatten(cache)}
    for t in toks:
        cache, lg = dec(params, cache, t)
        logits.append(np_of(lg))
    return logits, first, {k: np_of(v) for k, v in zoo.flatten(cache)}


def _grads(model, params, batch, mesh_shape=None):
    """(loss, {leaf: gradient}) one device, or over a mesh."""
    if mesh_shape is None:
        loss, _, g = steps.loss_and_grads(model, params, batch)
        out = {k: v.detach().clone().numpy() for k, v in zoo.flatten(g)}
        for _, p in zoo.flatten(params):
            p.grad = None
            p.requires_grad_(False)
        return float(loss), out
    sp = _sharded(model, params, mesh_shape)
    loss, _, g = steps.sharded_loss_and_grads(model, sp, batch)
    return float(loss), {k: v.numpy() for k, v in zoo.flatten(g)}


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_reference_gspmd(ref, name):
    """One sharded step's loss and gradients over (2, 2) positions, each
    computing its heads of every SSM layer (and of the hybrid's shared
    block), against the reference's GSPMD ``value_and_grad`` over a (2, 2)
    mesh of four forced host devices: the loss within 1e-5 relative, each
    leaf within 1e-5 of its largest entry."""
    cfg, params, batch, _, _, _ = _case(ref, name)
    loss, grads = _grads(zoo.build(cfg, "cpu"), params, batch, (2, 2))
    want = float(ref[f"{name}:loss"])
    assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
    for leaf, g in grads.items():
        assert _rel(g, ref[f"{name}:grad:{leaf}"]) <= 1e-5, leaf


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_matches_reference_gspmd(ref, name):
    """The prefill and two decode steps over (2, 2) positions (the prefill
    in the FSDP layout, the decode weights-resident, the caches where the
    reference lays them out) against the reference's jitted sharded steps:
    every step's logits and every cache leaf — conv windows, states, the
    hybrid's K/V — after the prefill and after the decode within 1e-4 of
    the largest entry."""
    cfg, params, _, prompt, toks, S = _case(ref, name)
    model = zoo.build(cfg, "cpu")
    logits, first, last = _serve(model, _sharded(model, params, (2, 2)),
                                 prompt, toks, S)
    for i, lg in enumerate(logits):
        assert _rel(lg, ref[f"{name}:logits{i}"]) <= 1e-4, i
    for tag, cache in (("cache0", first), ("cache2", last)):
        for leaf, v in cache.items():
            if leaf != "len":
                assert _rel(v, ref[f"{name}:{tag}:{leaf}"]) <= 1e-4, \
                    (tag, leaf)


def _matches_one_device(cfg, params, batch, prompt, toks, S,
                        mesh_shape=(2, 2)):
    """The train step and the serving steps over ``mesh_shape`` positions
    against the port's one-device steps on the same parameters: loss,
    gradients, logits and caches within 1e-5 (of the loss, of each leaf's
    largest entry); no train step where ``batch`` is None."""
    model = zoo.build(cfg, "cpu")
    if batch is not None:
        l1, g1 = _grads(model, params, batch)
        ls, gs = _grads(model, params, batch, mesh_shape)
        assert abs(ls - l1) <= 1e-5 * abs(l1)
        for leaf, g in gs.items():
            assert _rel(g, g1[leaf]) <= 1e-5, leaf
    one = _serve(model, params, prompt, toks, S)
    got = _serve(model, _sharded(model, params, mesh_shape), prompt, toks, S)
    for a, b in zip(got[0], one[0]):
        assert _rel(a, b) <= 1e-5
    for ca, cb in zip(got[1:], one[1:]):
        for leaf in ca:
            assert _rel(ca[leaf], cb[leaf]) <= 1e-5, leaf


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_matches_one_device(ref, name):
    """The same steps over (2, 2) positions against the port's one-device
    steps on the same parameters, within 1e-5 (the 130-token case served
    only)."""
    _matches_one_device(*_case(ref, name))


def _row0(model, sp):
    """Data row 0 of ``sp``'s mesh and its view of the parameters."""
    row = shd.mesh_rows(next(iter(zoo.flatten(sp)))[1].sharding.mesh)[0]
    return row, shd.bind_row(sp, model.abstract_params()[1], row,
                             whole=False)


def test_heads_that_do_not_divide_model():
    """Reduced mamba2 at d_model 96 and head dim 64 (d_inner 192: 3
    heads, 419 ``in_proj`` columns) on ``model`` 2: ``resolve`` replicates
    the heads and ``in_proj`` but splits the conv channels, ``norm`` and
    ``out_proj``'s rows, so every position computes all three heads and
    its rows' share of ``out_proj``; within 1e-5 of one device.  At the
    reduced width each position computes its 4 of the 8 heads."""
    odd = {"d_model": 96, "ssm_headdim": 64}
    case = _own_case("mamba2-1.3b", odd)
    _matches_one_device(*case)
    for over, want in ((odd, [(0, 3, 0, 96), (0, 3, 96, 192)]),
                       ({}, [(0, 4, 0, 128), (4, 8, 128, 256)])):
        cfg = _cfg("mamba2-1.3b", over)
        model = zoo.build(cfg, "cpu")
        row, bound = _row0(model, _sharded(model, model.init(0), (2, 2)))
        ssm = transformer.layer(bound["layers"], 0)["ssm"]
        plans = TPS.ssm_plans(cfg, row, ssm)
        assert [(p.h0, p.h1, p.r_lo, p.r_hi) for p in plans] == want
        assert ssm["in_proj"].model_split() == (not over)
        assert ssm["conv_w"].model_split() and ssm["out_proj"].model_split()


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}),
                                       ("zamba2-7b", {"n_layers": 3})])
def test_decode_reads_its_cache_and_gathers_no_parameter(arch, over):
    """A traced decode cell (batch 8 at 128 positions, weights resident)
    on a (4, 2) meta mesh: every parameter a position computes with is a
    view of its own block (no gather), no cache block (conv window, state,
    the hybrid's K/V) is read by or written from another position — each
    conv and state block written through its own position's view — and
    what moves between positions is the token's projections and conv
    outputs, the sums and the attention's partials: less than one layer's
    parameters."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), **over)
    mesh = _cpu_mesh((4, 2), "meta")
    gathered, held = [], []
    real_assemble, real_held = shd.RowLeaf.assemble, shd.RowCache.held

    def spy(self):
        out = real_assemble(self)
        own = self.leaf.shards[self.target].untyped_storage()._cdata
        gathered.append((self.name, out.untyped_storage()._cdata == own))
        return out

    def spy_held(self, pos):
        got = real_held(self, pos)
        own = self.leaf.shards[pos].untyped_storage()._cdata
        held.append((pos in self.row.tp, got is None or
                     got[0].untyped_storage()._cdata == own))
        return got
    shd.RowLeaf.assemble, shd.RowCache.held = spy, spy_held
    try:
        acc = steps.lower_cell(zoo.build(cfg, "meta"),
                               ShapeSpec("d", 128, 8, "decode"), mesh)
    finally:
        shd.RowLeaf.assemble, shd.RowCache.held = real_assemble, real_held
    assert gathered and all(own for _, own in gathered), \
        [n for n, own in gathered if not own]
    assert held and all(a and b for a, b in held)
    kinds = {}
    for kind, nb, scale, srcs, dst, _ in acc.events:
        if any(s != dst for s in srcs):
            kinds[kind] = kinds.get(kind, 0) + nb * scale
    assert not any(k.startswith("cache") for k in kinds), kinds
    assert set(kinds) <= {"all-reduce", "all-gather"}, kinds
    shapes = zoo.build(cfg, "meta").abstract_params()[0]
    stacks = {k: shapes[k] for k in ("layers", "groups", "tail")
              if k in shapes}
    layer = sum(t.numel() * 2 for _, t in zoo.flatten(stacks)) \
        // cfg.n_layers
    assert sum(kinds.values()) < layer, (kinds, layer)


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}),
                                       ("zamba2-7b", {"n_layers": 3})])
def test_one_gradient_block_a_position_bit_for_bit(arch, over):
    """Batch 8 × 24 over (2, 2) positions: after the step every leaf — the
    hybrid's shared block, gathered once and applied at every group,
    included — has one gradient tensor a block's first copy, of the
    block's shape and storage, and two runs are equal bit for bit
    (PyTorch's deterministic algorithms on: its CPU ``index_put_`` adds
    duplicate ids in a thread-dependent order otherwise)."""
    cfg, params, batch, _, _, _ = _own_case(arch, over)
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
    with _deterministic():
        runs = [steps.row_grads(model, sp, batch) for _ in range(2)]
    (b1, l1), (b2, l2) = runs
    assert float(l1) == float(l2)
    for name, p in zoo.flatten(sp):
        if not p.numel():
            continue
        sh = p.sharding
        block = sh.shard_shape(p.shape)
        firsts = sorted(pos for pos in sh.positions()
                        if sh.is_first_copy(pos))
        assert sorted(b1[name]) == firsts, name
        for pos, g in b1[name].items():
            assert tuple(g.shape) == block
            assert g.untyped_storage().nbytes() == \
                g.numel() * g.element_size()
            assert torch.equal(g, b2[name][pos]), (name, pos)


@pytest.mark.parametrize("arch,serves", [("mamba2-1.3b", True),
                                         ("zamba2-7b", False)])
def test_batch_of_one_serves_where_its_cache_lies(arch, serves):
    """A batch of one over (2, 2) positions: every data row computes the
    one prompt, as the reference replicates it.  mamba2's conv and state
    caches replicate over ``data`` too, so each row's positions hold their
    blocks and compute over ``model``; the hybrid's K/V puts ``kv_seq`` on
    (data, model), so a row's blocks lie on other data rows and it keeps
    the storage-only path (``tensor_parallel.serves``).  Either way the
    logits and the cache equal one device's within 1e-5."""
    from repro_torch.models import tensor_parallel as TP
    cfg, params, _, prompt, toks, S = _own_case(
        arch, {"n_layers": 3} if arch == "zamba2-7b" else {})
    prompt = {"tokens": prompt["tokens"][:1]}
    toks = [t[:1] for t in toks]
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
    mesh = next(iter(zoo.flatten(sp)))[1].sharding.mesh
    c_shapes = model.abstract_cache(1, S + EXTRA)
    c_axes = model.cache_axes()
    cache = shd.tree_map(lambda t, sh: shd.zeros(tuple(t.shape), t.dtype, sh),
                         c_shapes, shd.tree_shardings(c_axes, c_shapes, mesh))
    row = shd.mesh_rows(mesh)[0]
    rc = shd.bind_cache(cache, c_axes, row, shd.row_rows(mesh, 1, row.pos))
    assert TP.serves(cfg, row, rc) is serves
    got = _serve(model, sp, prompt, toks, S)
    one = _serve(model, params, prompt, toks, S)
    for a, b in zip(got[0], one[0]):
        assert _rel(a, b) <= 1e-5
    for ca, cb in zip(got[1:], one[1:]):
        for leaf in ca:
            assert _rel(ca[leaf], cb[leaf]) <= 1e-5, leaf


def test_rows_sharing_a_device_hold_no_gradient_part():
    """Over (2, 2) positions of one device the rows take their backwards
    in turn, so each gradient part is added as it comes and none waits in
    its slot: a position gathers several ``in_proj`` ranges a layer, and a
    held part would keep its range's gradient alive until the next row's
    backward (on the card, 1.5 GB at zamba2's depth 7, 520 tokens)."""
    cfg, params, batch, _, _, _ = _own_case("mamba2-1.3b")
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
    waited, real = [], shd.RowGroup.add_grad

    def spy(self, *a, **k):
        real(self, *a, **k)
        waited.append(sum(len(ch.held) for ch in self._chains.values()))
    shd.RowGroup.add_grad = spy
    try:
        blocks, _ = steps.row_grads(model, sp, batch)
    finally:
        shd.RowGroup.add_grad = real
    assert waited and not any(waited)
    assert sorted(blocks) == sorted(name for name, _ in zoo.flatten(sp))
