"""Tensor-parallel compute over ``model`` for the MoE and enc-dec families
(the port's ``models.tensor_parallel``), held against the reference's
GSPMD step and against the port's own one-device step.

* The reference's sharded steps: one subprocess (XLA's forced host device
  count must be set before JAX starts) runs, for reduced qwen3-moe-30b-a3b,
  arctic-480b and whisper-medium (its 32 frames on ``model`` 2: the cross
  cache split by sequence; 33 frames: split by heads), ``value_and_grad``
  of the forward, the prefill and two decode steps, each ``jax.jit`` with
  the reference's shardings over ``make_host_mesh(4, model=2)`` under
  ``use_mesh``, and a capacity-bound MoE forward (2100 tokens a row, top-2,
  ``capacity_factor`` 0.5) whose dropped pairs it counts; the port runs the
  same parameters (``zoo.params_from_numpy``) over a (2, 2) mesh of
  repeated CPU devices, each position computing its ``model`` share: the
  loss within 1e-5 relative and every gradient leaf within 1e-5 of its
  largest entry, the logits and every cache leaf within 1e-4 of the
  largest, the same dropped pairs a layer.
* The port's one-device steps: the same within 1e-5, and the fallthroughs
  of ``resolve``: experts that do not divide ``model`` (every position
  computes them all, position 0's result the layer's) and a vocabulary
  that does not (the whole-vocab logits).
* The layout: a traced decode cell of each family gathers no parameter and
  copies no cache block between positions; after a train step each
  position holds one gradient block a leaf, and two runs are equal bit
  for bit.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe, tensor_parallel as TP
from repro_torch.models import transformer, zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name -> (config, overrides of the reduced config)
CASES = {"qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
         "arctic-480b": ("arctic-480b", {}),
         "whisper-medium": ("whisper-medium", {}),
         "whisper-medium:33": ("whisper-medium", {"enc_len": 33})}
DROP = ("qwen3-moe-30b-a3b", {"capacity_factor": 0.5})
DROP_SEQ = 2100                        # 2100 · top-2 > 4096: capacity-bound
B, S, EXTRA = 4, 24, 4                 # batch, prompt positions, max_len room
TRAIN = (8, 64)                        # train batch rows, tokens

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses, json
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config, reduced_for_smoke
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe as jmoe
    from repro.models import zoo
    from repro.models.base import tree_unbox

    cases, drop, drop_seq, B, S, extra, train, out = json.loads(sys.argv[1])
    mesh = make_host_mesh(4, model=2)
    res = {}

    def flat(tree, prefix):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(str(k.key) for k in path)
            res[f"{prefix}:{name}"] = np.asarray(v, np.float32)

    def shardings(axes, tree):
        return jax.tree_util.tree_map(
            lambda ax, t: shd.sharding_for(ax, t.shape, mesh), axes, tree)

    def setup(name, arch, over, rows, seq):
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                                  grad_accum=1, **over)
        model = zoo.build(cfg)
        params, axes = tree_unbox(model.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(11)
        batch = {k: rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
        flat(params, f"{name}:params")
        for k, v in batch.items():
            res[f"{name}:batch:{k}"] = v
        b_sh = {k: shd.sharding_for("batch|seq|embed" if k == "frames"
                                    else "batch|seq", v.shape, mesh)
                for k, v in batch.items()}
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        return cfg, model, params, axes, batch, b_sh, rng

    def train_case(name, model, params, axes, batch, b_sh):
        with shd.use_mesh(mesh):
            p_sh = shardings(axes, params)
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: model.forward(p, b)[0]),
                in_shardings=(p_sh, b_sh))
            loss, g = grad(jax.device_put(params, p_sh),
                           jax.device_put(batch, b_sh))
        res[f"{name}:loss"] = np.asarray(loss)
        flat(g, f"{name}:grad")

    for name, (arch, over) in cases.items():
        cfg, model, params, axes, batch, b_sh, rng = setup(
            name, arch, over, *train)
        train_case(name, model, params, axes, batch, b_sh)
        prompt = {"tokens": rng.integers(0, cfg.vocab, (B, S))
                  .astype(np.int32)}
        if cfg.family == "encdec":
            prompt["frames"] = rng.normal(
                size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
        toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                for _ in range(2)]
        for k, v in prompt.items():
            res[f"{name}:batch:prompt_{k}"] = v
        for i, t in enumerate(toks):
            res[f"{name}:batch:token{i}"] = t
        max_len = S + extra
        with shd.use_mesh(mesh):
            p_sh = shardings(axes, params)
            c_shapes = model.abstract_cache(B, max_len)
            c_sh = shardings(model.cache_axes(), c_shapes)
            l_sh = shd.sharding_for("batch|seq|vocab", (B, 1, cfg.vocab),
                                    mesh)
            pr_sh = {k: shd.sharding_for("batch|seq|embed" if k == "frames"
                                         else "batch|seq", v.shape, mesh)
                     for k, v in prompt.items()}
            pre = jax.jit(lambda p, b: model.prefill(p, b, max_len),
                          in_shardings=(p_sh, pr_sh),
                          out_shardings=(c_sh, l_sh))
            cache, lg = pre(params, {k: jnp.asarray(v)
                                     for k, v in prompt.items()})
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

    # The capacity-bound case: the loss and gradients, and the pairs each
    # layer keeps (the nonzero rows of its dispatch buffer).
    cfg, model, params, axes, batch, b_sh, _ = setup(
        "drop", drop[0], drop[1], B, drop_seq)
    train_case("drop", model, params, axes, batch, b_sh)
    kept, calls, real = [], [0], jmoe.hint

    def spy(x, axes_):
        if axes_ == "batch|experts|capacity|embed":
            calls[0] += 1
            if calls[0] % 2:                 # the buffer, not the output
                jax.debug.callback(lambda b: kept.append(
                    int((np.abs(np.asarray(b)).sum(-1) > 0).sum())), x)
        return real(x, axes_)
    jmoe.hint = spy
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: model.forward(p, b)[0])(params, batch))
    finally:
        jmoe.hint = real
    res["drop:kept"] = np.asarray(kept, np.int64)
    np.savez(out, **res)
    print(json.dumps({"ok": True}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case of ``CASES`` and the
    capacity-bound case (one subprocess), keyed ``case:what[:leaf]``."""
    out = str(tmp_path_factory.mktemp("tpme") / "ref.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    arg = [CASES, DROP, DROP_SEQ, B, S, EXTRA, TRAIN, out]
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


def _case(ref, name, arch, over):
    """(cfg, port parameters, train batch, prompt, decode tokens) of case
    ``name`` from the reference's run (no prompt for the capacity case)."""
    cfg = _cfg(arch, over)
    pre = f"{name}:params:"
    tree = _unflat({k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)})
    params = zoo.params_from_numpy(cfg, tree, "cpu")

    def get(k):
        return torch.from_numpy(ref[f"{name}:batch:{k}"])
    keys = ("tokens", "labels", "frames") if cfg.family == "encdec" else \
        ("tokens", "labels")
    batch = {k: get(k) for k in keys}
    if f"{name}:batch:prompt_tokens" not in ref:
        return cfg, params, batch, None, None
    prompt = {k: get("prompt_" + k) for k in keys if k != "labels"}
    return cfg, params, batch, prompt, [get("token0"), get("token1")]


def _own_case(name, over=None):
    """(cfg, parameters drawn by the port, train batch, prompt, tokens) of
    ``name`` (a config id) with ``over`` its reduced config's overrides."""
    cfg = _cfg(name, over or {})
    model = zoo.build(cfg, "cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, TRAIN)
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    prompt = {"tokens": batch["tokens"][:B, :S]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(TRAIN[0], cfg.enc_len, cfg.d_model)).astype(np.float32))
        prompt["frames"] = batch["frames"][:B]
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                             .astype(np.int32)) for _ in range(2)]
    return cfg, model.init(0), batch, prompt, toks


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


def _row0(model, sp):
    """Data row 0 of ``sp``'s mesh and its view of the parameters."""
    row = shd.mesh_rows(next(iter(zoo.flatten(sp)))[1].sharding.mesh)[0]
    return row, shd.bind_row(sp, model.abstract_params()[1], row,
                             whole=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_reference_gspmd(ref, name):
    """One sharded step's loss and gradients over (2, 2) positions, each
    computing its ``model`` share, against the reference's GSPMD
    ``value_and_grad`` over a (2, 2) mesh of four forced host devices: the
    loss within 1e-5 relative, each leaf within 1e-5 of its largest
    entry."""
    cfg, params, batch, _, _ = _case(ref, name, *CASES[name])
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
    every step's logits and every cache leaf — the enc-dec's cross K/V
    split by sequence at 32 frames, by heads at 33 — after the prefill and
    after the decode within 1e-4 of the largest entry."""
    cfg, params, _, prompt, toks = _case(ref, name, *CASES[name])
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
    logits, first, last = _serve(model, sp, prompt, toks)
    for i, lg in enumerate(logits):
        assert _rel(lg, ref[f"{name}:logits{i}"]) <= 1e-4, i
    for tag, cache in (("cache0", first), ("cache2", last)):
        for leaf, v in cache.items():
            if leaf != "len":
                assert _rel(v, ref[f"{name}:{tag}:{leaf}"]) <= 1e-4, \
                    (tag, leaf)


def _matches_one_device(cfg, params, batch, prompt, toks, mesh_shape=(2, 2)):
    """The train step and the serving steps over ``mesh_shape`` positions
    against the port's one-device steps on the same parameters: loss,
    gradients, logits and caches within 1e-5 (of the loss, of each leaf's
    largest entry)."""
    model = zoo.build(cfg, "cpu")
    l1, g1 = _grads(model, params, batch)
    ls, gs = _grads(model, params, batch, mesh_shape)
    assert abs(ls - l1) <= 1e-5 * abs(l1)
    for leaf, g in gs.items():
        assert _rel(g, g1[leaf]) <= 1e-5, leaf
    one = _serve(model, params, prompt, toks)
    got = _serve(model, _sharded(model, params, mesh_shape), prompt, toks)
    for a, b in zip(got[0], one[0]):
        assert _rel(a, b) <= 1e-5
    for ca, cb in zip(got[1:], one[1:]):
        for leaf in ca:
            assert _rel(ca[leaf], cb[leaf]) <= 1e-5, leaf


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_matches_one_device(ref, name):
    """The same steps over (2, 2) positions against the port's one-device
    steps on the same parameters, within 1e-5."""
    _matches_one_device(*_case(ref, name, *CASES[name]))


def test_cross_cache_layouts_follow_resolve():
    """``resolve`` puts the cross cache's frames on ``model`` where they
    divide it (32 frames on 2) and its KV heads where they do not (33):
    both layouts the (2, 2) serving tests above read in place."""
    want = {32: (None, "data", "model", None, None),
            33: (None, "data", None, "model", None)}
    for frames, spec in want.items():
        cfg = _cfg("whisper-medium", {"enc_len": frames})
        model = zoo.build(cfg, "meta")
        shapes = model.abstract_cache(B, S + EXTRA)
        sh = shd.tree_shardings(model.cache_axes(), shapes,
                                _cpu_mesh((2, 2), "meta"))
        assert sh["cross_k"].spec == spec and sh["cross_v"].spec == spec


@contextlib.contextmanager
def _kept_by_layer(n_layers):
    """Each MoE layer's kept pairs, summed over the data rows' threads
    (each thread's calls in layer order)."""
    got = []
    moe.route_hook = lambda sel, keep: got.append(
        (threading.get_ident(), int(keep.sum())))
    out = [0] * n_layers
    try:
        yield out
    finally:
        moe.route_hook = None
    seen = {}
    for ident, kept in got:
        i = seen.get(ident, 0)
        seen[ident] = i + 1
        out[i % n_layers] += kept


def test_capacity_drops_match_reference(ref):
    """Reduced qwen3-moe with ``capacity_factor`` 0.5 over 4 × 2100 tokens
    (2100 · top-2 > 4096 pairs a row: capacity-bound): over (2, 2)
    positions, each routing its block of experts' pairs from the row's one
    route, every layer drops pairs and keeps as many as the reference's
    GSPMD forward does, and the loss and gradients match the reference's
    within 1e-5."""
    cfg, params, batch, _, _ = _case(ref, "drop", *DROP)
    model = zoo.build(cfg, "cpu")
    with _kept_by_layer(cfg.n_layers) as kept:
        loss, grads = _grads(model, params, batch, (2, 2))
    pairs = batch["tokens"].numel() * cfg.top_k
    want = [int(k) for k in ref["drop:kept"]]
    assert kept == want, (kept, want)
    assert all(k < pairs for k in kept), (kept, pairs)
    assert abs(loss - float(ref["drop:loss"])) <= \
        1e-5 * abs(float(ref["drop:loss"]))
    for leaf, g in grads.items():
        assert _rel(g, ref[f"drop:grad:{leaf}"]) <= 1e-5, leaf


def test_experts_that_do_not_divide_model():
    """Reduced qwen3-moe with 3 experts on ``model`` 2: ``resolve``
    replicates the experts (and splits their ``d_ff``), so every position
    computes all three from the whole leaves and position 0's result is
    the layer's; within 1e-5 of one device."""
    case = _own_case("qwen3-moe-30b-a3b", {"n_experts": 3})
    _matches_one_device(*case)
    cfg, params = case[:2]
    model = zoo.build(cfg, "cpu")
    row, bound = _row0(model, _sharded(model, params, (2, 2)))
    part = TP._moe_part(row, transformer.layer(bound["layers"], 0)["moe"])
    assert not part["split"] and part["spans"] == [(0, 3), (0, 3)]
    assert [tuple(p["wi"].shape) for p in part["p"]] == \
        [(3, cfg.d_model, cfg.moe_ff)] * 2
    full = _cfg("qwen3-moe-30b-a3b", {})
    fmodel = zoo.build(full, "cpu")
    row, bound = _row0(fmodel, _sharded(fmodel, fmodel.init(0), (2, 2)))
    part = TP._moe_part(row, transformer.layer(bound["layers"], 0)["moe"])
    assert part["split"] and part["spans"] == [(0, 4), (4, 8)]


def test_vocab_that_does_not_divide_model():
    """Reduced whisper-medium with 513 tokens (whisper's 51,865 divide
    neither 2 nor 16): the embedding replicates over ``model``, position 0
    computes the whole vocabulary's logits and loss; within 1e-5 of one
    device."""
    case = _own_case("whisper-medium", {"vocab": 513})
    _matches_one_device(*case)


def test_families_over_model():
    """The MoE, enc-dec, SSM and hybrid families compute over ``model`` on
    a row of more than one position (the SSM and hybrid through
    ``tensor_parallel_ssm``), and every family stays storage-only on a row
    of one."""
    rows = {shape: shd.mesh_rows(_cpu_mesh(shape, "meta"))[0]
            for shape in ((2, 2), (2, 1))}
    for arch in ("qwen3-moe-30b-a3b", "arctic-480b", "whisper-medium",
                 "mamba2-1.3b", "zamba2-7b"):
        cfg = get_config(arch)
        assert TP.active(cfg, rows[(2, 2)]), arch
        assert not TP.active(cfg, rows[(2, 1)]), arch


@pytest.mark.parametrize("arch,over", [
    ("qwen3-moe-30b-a3b", {}), ("whisper-medium", {}),
    ("whisper-medium", {"enc_len": 33})])
def test_decode_reads_its_cache_and_gathers_no_parameter(arch, over):
    """A traced decode cell (batch 8 at 128 positions, weights resident)
    on a (4, 2) meta mesh: every parameter a position computes with is a
    view of its own block (no gather) — a MoE position's experts and its
    router columns among them —, no cache block (self or cross, split by
    sequence or by heads) is read by or written from another position,
    and what moves between positions is the sums, the token's Q and K/V,
    the heads' partials and the router's logits and route: less than one
    layer's parameters."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), **over)
    mesh = _cpu_mesh((4, 2), "meta")
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
    assert set(kinds) <= {"all-reduce", "all-gather", "broadcast"}, kinds
    layers = zoo.build(cfg, "meta").abstract_params()[0]
    stacks = {k: v for k, v in layers.items() if k.endswith("layers")}
    layer = sum(t.numel() * 2 for _, t in zoo.flatten(stacks)) \
        // (cfg.n_layers + cfg.n_enc_layers)
    assert sum(kinds.values()) < layer, (kinds, layer)


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-medium"])
def test_one_gradient_block_a_position_bit_for_bit(arch):
    """Batch 8 × 64 over (2, 2) positions: after the step every leaf has
    one gradient tensor a block's first copy, of the block's shape and
    storage, and two runs are equal bit for bit (PyTorch's deterministic
    algorithms on: its CPU ``index_put_`` adds duplicate ids in a
    thread-dependent order otherwise)."""
    cfg, params, batch, _, _ = _own_case(arch)
    model = zoo.build(cfg, "cpu")
    sp = _sharded(model, params, (2, 2))
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
