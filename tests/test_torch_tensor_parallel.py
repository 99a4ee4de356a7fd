"""Tensor-parallel compute over ``model`` for the transformer family (the
port's ``models.tensor_parallel``), held against the reference's GSPMD
step and against the port's own one-device step.

* The reference's sharded steps: one subprocess (XLA's forced host device
  count must be set before JAX starts) runs, for each of the five dense
  and VLM configs reduced, ``value_and_grad`` of the forward, the prefill
  and two decode steps, each ``jax.jit`` with the reference's shardings
  over ``make_host_mesh(4, model=2)`` under ``use_mesh`` (its activation
  hints on), and writes the results to an ``.npz``; the port runs the same
  parameters (``zoo.params_from_numpy``) over a (2, 2) mesh of repeated
  CPU devices, each position computing its ``model`` share: the loss
  within 1e-5 relative and every gradient leaf within 1e-5 of its largest
  entry, the logits and every cache leaf within 1e-4 of the largest.
* The port's one-device steps: the same within 1e-5.
* The fallthroughs of ``resolve``: KV heads that do not divide ``model``
  while the Q heads do (each position reads the KV head its Q heads
  read), and Q heads that do not divide it (every position computes all
  heads, ``wo``'s rows still split).
* The layout: a traced decode cell gathers no parameter and copies no
  cache block between positions; after a train step each position holds
  one gradient block a leaf, and two runs are equal bit for bit.
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
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import transformer, zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3.2-3b", "qwen2-0.5b", "granite-8b", "qwen2-72b",
         "paligemma-3b"]
B, S, EXTRA = 4, 24, 4                 # batch, prompt positions, max_len room

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

    archs, B, S, extra, out = json.loads(sys.argv[1])
    mesh = make_host_mesh(4, model=2)
    res = {}

    def flat(tree, prefix):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(str(k.key) for k in path)
            res[f"{prefix}:{name}"] = np.asarray(v, np.float32)

    def shardings(axes, tree):
        return jax.tree_util.tree_map(
            lambda ax, t: shd.sharding_for(ax, t.shape, mesh), axes, tree)

    for arch in archs:
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                                  grad_accum=1)
        model = zoo.build(cfg)
        params, axes = tree_unbox(model.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(11)
        text = S - cfg.n_patches
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (8, 64 - cfg.n_patches))
                                .astype(np.int32)) for k in ("tokens", "labels")}
        b_axes = {"tokens": "batch|seq", "labels": "batch|seq"}
        if cfg.family == "vlm":
            batch["patch_embs"] = jnp.asarray(rng.normal(
                size=(8, cfg.n_patches, cfg.d_model)).astype(np.float32))
            b_axes["patch_embs"] = "batch|seq|embed"
        prompt = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, text))
                                        .astype(np.int32))}
        p_axes = {"tokens": "batch|seq"}
        if cfg.family == "vlm":
            prompt["patch_embs"] = jnp.asarray(rng.normal(
                size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
            p_axes["patch_embs"] = "batch|seq|embed"
        toks = [jnp.asarray(rng.integers(0, cfg.vocab, (B, 1))
                            .astype(np.int32)) for _ in range(2)]
        flat(params, f"{arch}:params")
        for k, v in list(batch.items()) + [("prompt_" + k, v) for k, v in
                                           prompt.items()]:
            res[f"{arch}:batch:{k}"] = np.asarray(v)
        for i, t in enumerate(toks):
            res[f"{arch}:batch:token{i}"] = np.asarray(t)
        max_len = S + extra
        with shd.use_mesh(mesh):
            p_sh = shardings(axes, params)
            b_sh = {k: shd.sharding_for(b_axes[k], v.shape, mesh)
                    for k, v in batch.items()}
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: model.forward(p, b)[0]),
                in_shardings=(p_sh, b_sh))
            loss, g = grad(jax.device_put(params, p_sh),
                           jax.device_put(batch, b_sh))
            res[f"{arch}:loss"] = np.asarray(loss)
            flat(g, f"{arch}:grad")
            c_shapes = model.abstract_cache(B, max_len)
            c_sh = shardings(model.cache_axes(), c_shapes)
            l_sh = shd.sharding_for("batch|seq|vocab", (B, 1, cfg.vocab),
                                    mesh)
            pr_sh = {k: shd.sharding_for(p_axes[k], v.shape, mesh)
                     for k, v in prompt.items()}
            pre = jax.jit(lambda p, b: model.prefill(p, b, max_len),
                          in_shardings=(p_sh, pr_sh),
                          out_shardings=(c_sh, l_sh))
            cache, lg = pre(params, prompt)
            flat(cache, f"{arch}:cache0")
            res[f"{arch}:logits0"] = np.asarray(lg)
        with shd.use_mesh(mesh), shd.serve_mode():
            d_sh = shardings(axes, params)
            c_sh = shardings(model.cache_axes(), c_shapes)
            t_sh = shd.sharding_for("batch|seq", (B, 1), mesh)
            dec = jax.jit(lambda p, c, t: model.decode(p, c, t),
                          in_shardings=(d_sh, c_sh, t_sh),
                          out_shardings=(c_sh, l_sh))
            for i, t in enumerate(toks):
                cache, lg = dec(params, cache, t)
                res[f"{arch}:logits{i + 1}"] = np.asarray(lg)
            flat(cache, f"{arch}:cache2")
    np.savez(out, **res)
    print(json.dumps({"ok": True}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every config of ``ARCHS`` (one
    subprocess), keyed ``arch:what[:leaf]``."""
    out = str(tmp_path_factory.mktemp("tp") / "ref.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps([ARCHS, B, S, EXTRA, out])],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        return dict(f.items())


def _cpu_mesh(shape):
    return Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
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


def _case(ref, arch):
    """(cfg, port parameters, train batch, prompt, decode tokens) of
    ``arch`` from the reference's run."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              grad_accum=1)
    pre = f"{arch}:params:"
    tree = _unflat({k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)})
    params = zoo.params_from_numpy(cfg, tree, "cpu")

    def get(k):
        return torch.from_numpy(ref[f"{arch}:batch:{k}"])
    batch = {k: get(k) for k in ("tokens", "labels")}
    prompt = {"tokens": get("prompt_tokens")}
    if cfg.family == "vlm":
        batch["patch_embs"] = get("patch_embs")
        prompt["patch_embs"] = get("prompt_patch_embs")
    return cfg, params, batch, prompt, [get("token0"), get("token1")]


def _sharded(model, params, mesh_shape):
    shapes, axes = model.abstract_params()
    return shd.place_tree(params, shd.tree_shardings(
        axes, shapes, _cpu_mesh(mesh_shape)))


def _serve(model, params, prompt, toks):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_gspmd(ref, arch):
    """One sharded step's loss and gradients over (2, 2) positions, each
    computing its ``model`` share, against the reference's GSPMD
    ``value_and_grad`` over a (2, 2) mesh of four forced host devices:
    the loss within 1e-5 relative, each leaf within 1e-5 of its largest
    entry."""
    cfg, params, batch, _, _ = _case(ref, arch)
    model = zoo.build(cfg, "cpu")
    loss, grads = _grads(model, params, batch, (2, 2))
    want = float(ref[f"{arch}:loss"])
    assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
    for name, g in grads.items():
        assert _rel(g, ref[f"{arch}:grad:{name}"]) <= 1e-5, name


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_gspmd(ref, arch):
    """The prefill and two decode steps over (2, 2) positions (the prefill
    in the FSDP layout, the decode weights-resident, the cache where the
    reference lays it out) against the reference's jitted sharded steps:
    every step's logits and every cache leaf after the prefill and after
    the decode within 1e-4 of the largest entry."""
    cfg, params, _, prompt, toks = _case(ref, arch)
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
    logits, first, last = _serve(model, sp, prompt, toks)
    for i, lg in enumerate(logits):
        assert _rel(lg, ref[f"{arch}:logits{i}"]) <= 1e-4, i
    for tag, cache in (("cache0", first), ("cache2", last)):
        for name, v in cache.items():
            if name != "len":
                assert _rel(v, ref[f"{arch}:{tag}:{name}"]) <= 1e-4, \
                    (tag, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_matches_one_device(ref, arch):
    """The same steps over (2, 2) positions against the port's one-device
    steps on the same parameters: loss, gradients, logits and caches
    within 1e-5 (of the loss, of each leaf's largest entry)."""
    cfg, params, batch, prompt, toks = _case(ref, arch)
    model = zoo.build(cfg, "cpu")
    l1, g1 = _grads(model, params, batch)
    ls, gs = _grads(model, params, batch, (2, 2))
    assert abs(ls - l1) <= 1e-5 * abs(l1)
    for name, g in gs.items():
        assert _rel(g, g1[name]) <= 1e-5, name
    one = _serve(model, params, prompt, toks)
    got = _serve(model, _sharded(model, params, (2, 2)), prompt, toks)
    for a, b in zip(got[0], one[0]):
        assert _rel(a, b) <= 1e-5
    for ca, cb in zip(got[1:], one[1:]):
        for name in ca:
            assert _rel(ca[name], cb[name]) <= 1e-5, name


def _fallthrough(over: dict, mesh_shape):
    """Reduced llama3.2-3b with ``over`` over ``mesh_shape`` positions: the
    head plans, and the train step and serving against one device."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              **over)
    model = zoo.build(cfg, "cpu")
    params = model.init(0)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    prompt = {"tokens": batch["tokens"][:, :S]}
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))
                             .astype(np.int32)) for _ in range(2)]
    l1, g1 = _grads(model, params, batch)
    ls, gs = _grads(model, params, batch, mesh_shape)
    assert abs(ls - l1) <= 1e-5 * abs(l1)
    for name, g in gs.items():
        assert _rel(g, g1[name]) <= 1e-5, name
    one = _serve(model, params, prompt, toks)
    got = _serve(model, _sharded(model, params, mesh_shape), prompt, toks)
    for a, b in zip(got[0], one[0]):
        assert _rel(a, b) <= 1e-5
    for ca, cb in zip(got[1:], one[1:]):
        for name in ca:
            assert _rel(ca[name], cb[name]) <= 1e-5, name
    sp = _sharded(model, params, mesh_shape)
    row = shd.mesh_rows(sp["embed"]["tok"].sharding.mesh)[0]
    bound = shd.bind_row(sp, model.abstract_params()[1], row, whole=False)
    return cfg, TP.head_plans(cfg, row, transformer.layer(
        bound["layers"], 0)["attn"])


def test_kv_heads_replicate_while_heads_split():
    """4 Q heads over 2 KV heads on ``model`` 4: each position computes one
    Q head and the KV head it reads, whose columns ``model`` splits in
    halves (gathered over ``model`` as well); within 1e-5 of one device."""
    cfg, plans = _fallthrough({}, (1, 4))
    assert [(p.lo, p.hi, p.c_lo, p.c_hi) for p in plans] == \
        [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]
    assert [(p.r_lo, p.r_hi) for p in plans] == \
        [(i * cfg.hd, (i + 1) * cfg.hd) for i in range(4)]


def test_heads_that_do_not_divide_model():
    """6 Q heads over 2 KV heads on ``model`` 4 (two data rows): every
    position computes all heads' attention, ``wq``'s columns gathered over
    ``model``, and its block of ``wo``'s rows (a head and a half) into the
    sum; within 1e-5 of one device."""
    cfg, plans = _fallthrough({"n_heads": 6, "n_kv_heads": 2}, (2, 4))
    assert {(p.lo, p.hi) for p in plans} == {(0, 6)}
    rows = 6 * cfg.hd // 4
    assert [(p.r_lo, p.r_hi) for p in plans] == \
        [(i * rows, (i + 1) * rows) for i in range(4)]


def test_decode_reads_its_cache_and_gathers_no_parameter():
    """A traced decode cell of reduced llama3.2-3b (batch 8 at 128
    positions, weights resident) on a (4, 2) meta mesh: every parameter a
    position computes with is a view of its own block (no gather), no
    cache block is read by or written from another position, and what
    moves between positions is the sums, the token's Q and K/V and the
    heads' partials — less than one layer's parameters."""
    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    mesh = Mesh(np.array([torch.device("meta")] * 8,
                         dtype=object).reshape(4, 2), ("data", "model"))
    gathered = []
    real = shd.RowLeaf.assemble

    def spy(self):
        out = real(self)
        own = self.leaf.shards[self.target].untyped_storage()._cdata
        gathered.append((self.name, out.untyped_storage()._cdata == own))
        return out
    shd.RowLeaf.assemble = spy
    try:
        acc = steps.lower_cell(zoo.build(cfg, "meta"),
                               ShapeSpec("d", 128, 8, "decode"), mesh)
    finally:
        shd.RowLeaf.assemble = real
    assert gathered and all(own for _, own in gathered), \
        [n for n, own in gathered if not own]
    kinds = {}
    for kind, nb, scale, srcs, dst, _ in acc.events:
        if any(s != dst for s in srcs):
            kinds[kind] = kinds.get(kind, 0) + nb * scale
    assert not any(k.startswith("cache") for k in kinds), kinds
    assert set(kinds) <= {"all-reduce", "all-gather"}, kinds
    layer = sum(t.numel() * 2 for _, t in zoo.flatten(
        zoo.build(cfg, "meta").abstract_params()[0]["layers"])) \
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


def test_one_gradient_block_a_position_bit_for_bit():
    """Reduced qwen2-0.5b (tied embeddings, QKV biases), batch 8 × 64 over
    (2, 2) positions: after the step every leaf has one gradient tensor a
    block's first copy, of the block's shape and storage, and two runs are
    equal bit for bit (PyTorch's deterministic algorithms on: its CPU
    ``index_put_`` adds duplicate ids in a thread-dependent order
    otherwise)."""
    cfg = reduced_for_smoke(get_config("qwen2-0.5b"))
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, model.init(0), (2, 2))
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with _deterministic():
        runs = [steps.row_grads(model, sp, batch) for _ in range(2)]
    (b1, l1), (b2, l2) = runs
    assert float(l1) == float(l2)
    for name, p in zoo.flatten(sp):
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
