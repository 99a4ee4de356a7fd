"""Twin of tests/test_distributed.py: the port's sharding policy and its
sharded execution held against the JAX package.

In process: the reference's seven ``resolve`` cells run on the port's
``distributed.sharding.resolve`` and are checked against the reference's
answer, and ``mesh_data_axes`` / ``data_axis_size`` / ``shard_devices`` and
``fusion.shard_ranges`` against the reference's over fake meshes and a grid
of shapes (fewer partitions than shards included).

In subprocesses: the reference's mesh cells need XLA's forced host device
count, which must be set before JAX starts, so each device count runs one
subprocess that imports both packages, runs the SAME program in each — the
reference over ``make_host_mesh(ndev)`` of forced CPU devices, the port
over ``Mesh([cpu] × ndev)`` — and prints one JSON line: per cell the
counters (``shards``, ``shard_merges``, ``shard_bytes_in``, ``streams``,
``passes``, ``partition_steps``, ``bytes_streamed``, ``pass_bytes_in``,
``epilogue_launches``), the kernels the kernel backend dispatches, and the
errors the reference's test holds to its own tolerances.  The parent test
asserts the counters and kernels exactly equal and the errors within the
reference test's tolerances.  ``test_mesh_parity_grid`` is the
reference's grid for ndev 1, 2 and 8 (its batch, spill and interrupted-
shard cases included); ``test_multidevice_equivalence`` both its parts
on a (4, 2) ``data × model`` mesh: data-parallel GenOps, and a sharded
train step of reduced llama3.2-3b (batch 8 × 64) against the reference's
8-device loss and the port's one-device loss and gradients.
``test_dryrun_smoke_subprocess`` is the reference's smoke cell in both
packages: reduced llama3.2-3b's train step on a (4, 2) mesh, lowered by
the reference over 8 forced host devices and traced by the port's
``lower_cell`` over meta devices.

The LM half, in process: ``zoo.Model.abstract_params`` axes equal to the
reference's ``tree_unbox`` axes for all ten configs; ``tree_shardings``
and ``train_specs`` specs leaf by leaf equal to the reference's
``resolve`` on stand-in (4, 2), (16, 16) and (2, 16, 16) meshes; the
sharded step of every family on a (2, 2) mesh of repeated CPU devices
against the port's one-device step, bit for bit run to run, each
position holding only its block of every parameter and moment; the
sharded prefill and decode of every family on a (2, 2) mesh against each
data row's rows run alone, bit for bit, and against the reference, a
batch of 1 replicated; ``prefill_specs`` and ``decode_specs`` leaf by
leaf against the reference's ``resolve``.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import dataclasses

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import fusion as jfusion
from repro.distributed import sharding as jshd
from repro.models import zoo as jzoo
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import fusion as tfusion
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.sharding import resolve
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import zoo
from repro_torch.optim import adam

pytestmark = pytest.mark.slow  # subprocess mesh runs, as the reference's

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH1 = _FakeMesh((16, 16), ("data", "model"))
MESH2 = _FakeMesh((2, 16, 16), ("pod", "data", "model"))


def _same_as_reference(axes, shape, mesh):
    spec = resolve(axes, shape, mesh)
    assert spec == tuple(jshd.resolve(axes, shape, mesh)), (axes, shape)
    return spec


def test_param_fsdp_tp():
    spec = _same_as_reference("d_model|d_ff", (8192, 29568), MESH1)
    assert spec == ("data", "model")


def test_head_divisibility_fallback():
    spec = _same_as_reference("d_model|heads", (2048, 8 * 256), MESH1)
    assert spec == ("data", "model")
    spec = _same_as_reference("batch|seq|act_heads|head_dim",
                              (16, 128, 8, 256), MESH1)
    assert spec[2] is None


def test_batch_prefers_pod_data():
    spec = _same_as_reference("batch|seq", (256, 4096), MESH2)
    assert spec[0] == ("pod", "data")


def test_batch_one_gives_axes_to_kv_seq():
    spec = _same_as_reference("batch|kv_seq|kv_heads|head_dim",
                              (1, 524288, 32, 112), MESH1)
    assert spec[0] is None
    assert spec[1] == ("data", "model")


def test_kv_seq_model_when_batch_takes_data():
    spec = _same_as_reference("batch|kv_seq|kv_heads|head_dim",
                              (128, 32768, 8, 128), MESH1)
    assert spec[0] == "data"
    assert spec[1] == "model"


def test_no_axis_used_twice():
    spec = _same_as_reference("d_ff|vocab", (29568, 152064), MESH1)
    used = [s for s in spec if s]
    assert len(set(used)) == len(used)


def test_scalar_replicated():
    assert _same_as_reference("", (), MESH1) == ()


class _DevMesh:
    """A fake mesh whose devices are labelled, so ``shard_devices``'s choice
    and order show."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape) \
            .astype(object)


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("model", "data")),
    ((8,), ("data",)),
    ((3, 5), ("x", "i")),
    ((4,), ("model",)),
    ((1, 1), ("data", "model")),
])
def test_mesh_axes_and_shard_devices(shape, names):
    """``mesh_data_axes``, ``data_axis_size`` and ``shard_devices`` equal
    the reference's, and ``rows|rep`` resolves alike."""
    mesh = _DevMesh(shape, names)
    assert tshd.mesh_data_axes(mesh) == jshd.mesh_data_axes(mesh)
    assert tshd.data_axis_size(mesh) == jshd.data_axis_size(mesh)
    assert tshd.shard_devices(mesh) == jshd.shard_devices(mesh)
    for n in (1, 64, 65608366):
        _same_as_reference("rows|rep", (n, 1), mesh)
        _same_as_reference("rep|rep", (n, 7), mesh)


def test_port_mesh_over_repeated_devices():
    """The port's ``Mesh`` takes repeated devices (as a JAX mesh built from
    an array does) and ``shard_devices`` walks the data axis."""
    cpu = torch.device("cpu")
    mesh = Mesh(np.array([cpu] * 8, dtype=object).reshape(4, 2),
                ("data", "model"))
    assert mesh.devices.shape == (4, 2)
    assert tshd.data_axis_size(mesh) == 4
    assert tshd.shard_devices(mesh) == [cpu] * 4
    with pytest.raises(ValueError):
        Mesh([cpu] * 4, ("data", "model"))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_ranges_grid(n_shards):
    """Contiguous, partition-aligned ranges equal to the reference's, over
    a grid that includes fewer partitions than shards."""
    for long_dim in (0, 1, 7, 64, 100, 512, 1000, 4097):
        for rows in (1, 8, 64, 512, 1 << 14):
            got = tfusion.shard_ranges(long_dim, rows, n_shards)
            assert got == jfusion.shard_ranges(long_dim, rows, n_shards)
            assert len(got) == n_shards
            assert got[0][0] == 0 and got[-1][1] == long_dim
            for (lo, hi), (lo2, _) in zip(got, got[1:]):
                assert hi == lo2 and lo <= hi
                assert lo % rows == 0 or lo == long_dim


# ---------------------------------------------------------------------------
# The LM half: logical axes, shardings, the sharded train step
# ---------------------------------------------------------------------------

_REF_TREES = {}


def _ref_tree(arch):
    """The reference's (shapes, axes) of ``arch``'s full parameter tree,
    flattened to dotted names, without allocating."""
    if arch not in _REF_TREES:
        import jax
        shapes, axes = jzoo.build(jget_config(arch)).abstract_params()

        def flat(tree):
            return {".".join(str(k.key) for k in path): v for path, v in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}
        _REF_TREES[arch] = ({k: tuple(v.shape) for k, v in
                             flat(shapes).items()}, flat(axes))
    return _REF_TREES[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_axes_match_reference(arch):
    """``Model.abstract_params``: meta tensors only, with the reference's
    shapes and '|'-joined logical axes leaf by leaf."""
    shapes, axes = zoo.build(get_config(arch), "cpu").abstract_params()
    ref_shapes, ref_axes = _ref_tree(arch)
    assert {t.device.type for _, t in zoo.flatten(shapes)} == {"meta"}
    assert dict(zoo.flatten(axes)) == ref_axes
    assert {k: tuple(t.shape) for k, t in zoo.flatten(shapes)} == ref_shapes


STAND_INS = {"4x2": _FakeMesh((4, 2), ("data", "model")),
             "16x16": MESH1, "2x16x16": MESH2}


@pytest.mark.parametrize("mesh_name", sorted(STAND_INS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_specs_match_reference_resolve(arch, mesh_name):
    """``train_specs`` at train_4k: every parameter's, moment's and batch
    input's spec equal to the reference's ``resolve`` of its axes and
    shape, the step and the metrics replicated."""
    mesh = STAND_INS[mesh_name]
    model = zoo.build(get_config(arch), "cpu")
    sp = steps.train_specs(model, ShapeSpec("train_4k", 4096, 256, "train"),
                           mesh)
    p_sh, o_sh, b_sh = sp["in_shardings"]
    assert sp["out_shardings"][:2] == (p_sh, o_sh)
    ref_shapes, ref_axes = _ref_tree(arch)
    want = {k: tuple(jshd.resolve(ref_axes[k], ref_shapes[k], mesh))
            for k in ref_axes}
    for tree in (p_sh, o_sh["m"], o_sh["v"]):
        got = {k: v.spec for k, v in zoo.flatten(tree)}
        assert got == want
    assert o_sh["step"].spec == () and o_sh["step"].mesh is mesh
    assert {v.spec for v in sp["out_shardings"][2].values()} == {()}
    jspec = jzoo.input_specs(jget_config(arch),
                             JShapeSpec("train_4k", 4096, 256, "train"))
    for k, v in b_sh.items():
        assert v.spec == tuple(jshd.resolve(jspec["axes"][k],
                                            jspec["batch"][k].shape, mesh))
    # tree_shardings over the same trees gives the same layout
    shapes, axes = model.abstract_params()
    assert tshd.tree_shardings(axes, shapes, mesh) == p_sh


def _cpu_mesh(shape, names=("data", "model")):
    return Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms, for a run-to-run comparison."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _reduced_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    text = S - cfg.n_patches
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, text))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embs"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch,accum", [
    ("llama3.2-3b", 1), ("qwen2-0.5b", 2), ("qwen3-moe-30b-a3b", 1),
    ("arctic-480b", 2), ("paligemma-3b", 1), ("mamba2-1.3b", 2),
    ("zamba2-7b", 2), ("whisper-medium", 1)])
def test_sharded_step_matches_one_device(arch, accum):
    """Every family's gradients over a (2, 2) mesh of repeated CPU devices
    against the port's one-device ``loss_and_grads`` of the same config on
    the same batch (8 rows in ``grad_accum`` microbatches; a MoE's
    load-balancing term over each whole microbatch on both sides): the
    loss within 1e-5 relative, each gradient leaf within 1e-5 of its
    largest entry (2e-2 for arctic-480b's bf16 masters and gradients), the
    hybrid's empty tail an empty gradient."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              grad_accum=accum)
    model = zoo.build(cfg, "cpu")
    params = model.init(0)
    batch = _reduced_batch(cfg, 8, 64 if cfg.family != "vlm"
                           else cfg.n_patches + 32)
    l1, _, g1 = steps.loss_and_grads(model, params, batch)
    g1 = {k: v.clone() for k, v in zoo.flatten(g1)}
    shapes, axes = model.abstract_params()
    sp = tshd.place_tree(params, tshd.tree_shardings(
        axes, shapes, _cpu_mesh((2, 2))))
    ls, _, gs = steps.sharded_loss_and_grads(model, sp, batch)
    tol = 2e-2 if cfg.param_dtype == "bfloat16" else 1e-5
    assert abs(float(ls) - float(l1)) <= tol * abs(float(l1))
    for name, g in zoo.flatten(gs):
        want = g1[name]
        assert g.shape == want.shape and g.dtype == want.dtype, name
        if want.numel() == 0:
            continue
        got = g.full().double()
        err = (got - want.double()).abs().max() / want.double().abs().max()
        assert float(err) <= tol, (name, float(err))


def test_sharded_moe_balance_term_is_global():
    """A MoE layer's load-balancing term over a (2, 2) mesh takes the whole
    batch's first-choice shares, as the reference's SPMD step does: the
    loss of reduced qwen3-moe-30b-a3b (batch 8 × 64 in one microbatch,
    parameters carried from the reference) equals the reference's
    forward's within 1e-5 with the term
    and without it — a term over each data row's tokens alone is off by
    more than that, which the loss with the term must not be."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_for_smoke as jreduced
    from repro.models import moe as jmoe
    from repro.models.base import tree_unbox
    from repro_torch.models import moe as tmoe
    arch = "qwen3-moe-30b-a3b"
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), grad_accum=1)
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              grad_accum=1)
    jparams, _ = tree_unbox(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    host = jax.tree_util.tree_map(np.asarray, jparams)
    batch = _reduced_batch(cfg, 8, 64)
    model = zoo.build(cfg, "cpu")
    shapes, axes = model.abstract_params()
    p_sh = tshd.tree_shardings(axes, shapes, _cpu_mesh((2, 2)))

    def losses():
        jloss, _ = jzoo.build(jcfg).forward(
            jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        sp = tshd.place_tree(zoo.params_from_numpy(cfg, host, "cpu"), p_sh)
        ls, _, _ = steps.sharded_loss_and_grads(model, sp, batch)
        return float(jloss), float(ls)
    ref, port = losses()
    assert abs(port - ref) <= 1e-5 * abs(ref), (ref, port)
    real = tshd.Row.gather_sum
    try:                           # each row's own shares: a local term
        tshd.Row.gather_sum = lambda self, value: value
        _, local = losses()
    finally:
        tshd.Row.gather_sum = real
    assert abs(local - ref) > 1e-5 * abs(ref), (ref, local)
    real = jmoe._aux_loss, tmoe.balance_loss
    try:
        jmoe._aux_loss = lambda gates, sel, E: jnp.zeros((), jnp.float32)
        tmoe.balance_loss = lambda bal, pe=None: bal.me.sum() * 0.0
        ref, port = losses()
    finally:
        jmoe._aux_loss, tmoe.balance_loss = real
    assert abs(port - ref) <= 1e-5 * abs(ref), (ref, port)


def test_sharded_train_step_layout_and_bit_for_bit():
    """Reduced llama3.2-3b, batch 8 × 64, two AdamW steps on a (4, 2) mesh
    of repeated CPU devices (its positions computing their ``model``
    shares), twice from the same start: the runs equal bit for bit, and
    every position of every parameter and moment holds its spec's block
    and nothing more.  PyTorch's deterministic algorithms are on: its CPU
    ``index_put_`` (the embedding lookup's backward) adds duplicate ids in
    a thread-dependent order otherwise."""
    _train_layout_bit_for_bit((4, 2))


def test_sharded_train_step_without_model_split_bit_for_bit():
    """``test_sharded_train_step_layout_and_bit_for_bit`` on a (2, 1) mesh:
    no ``model`` split, the tensor-parallel layout a no-op."""
    _train_layout_bit_for_bit((2, 1))


def _train_layout_bit_for_bit(shape):
    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    model = zoo.build(cfg, "cpu")
    shapes, axes = model.abstract_params()
    mesh = _cpu_mesh(shape)
    p_sh = tshd.tree_shardings(axes, shapes, mesh)
    batch = _reduced_batch(cfg, 8, 64)
    rows = tshd.sharding_for("batch|seq", (8, 64), mesh)
    assert rows.spec == ("data", None)
    sbatch = {k: tshd.place(v, rows) for k, v in batch.items()}
    step = steps.build_train_step(model)
    runs = []
    with _deterministic():
        for _ in range(2):
            params = tshd.place_tree(model.init(0), p_sh)
            opt = adam.init(params)
            for _ in range(2):
                params, opt, met = step(params, opt, sbatch)
            runs.append((params, opt, float(met["loss"])))
    (p1, o1, l1), (p2, o2, l2) = runs
    assert l1 == l2 and np.isfinite(l1)
    for t1, t2 in ((p1, p2), (o1["m"], o2["m"]), (o1["v"], o2["v"])):
        for (name, a), (_, b) in zip(zoo.flatten(t1), zoo.flatten(t2)):
            assert torch.equal(a.full(), b.full()), name
            block = a.sharding.shard_shape(a.shape)
            assert a.sharding.mesh == mesh
            for pos in a.sharding.positions():
                loc = a.local(pos)
                assert tuple(loc.shape) == block, (name, pos)
                assert loc.untyped_storage().nbytes() == \
                    loc.numel() * loc.element_size(), (name, pos)
    wq = p1["layers"]["attn"]["wq"]
    assert wq.sharding.spec == ((None, "data", "model") if shape[1] > 1
                                else (None, "data", None))
    assert o1["m"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert int(o1["step"].full()) == 2


def test_sharded_row_gradients_are_position_blocks():
    """Reduced llama3.2-3b, batch 8 × 64 on a (4, 2) mesh of repeated CPU
    devices: after the data rows' backward (``steps.row_grads``) the step
    holds one gradient tensor a block's first copy of every leaf, of that
    block's shape and storage, on the position's device — no whole-leaf
    gradient and no row's own copy anywhere — so a position holds one
    block a leaf, an eighth of the whole gradient here for a leaf split
    over both axes; laid out (``steps._grad_tree``) they are
    ``sharded_loss_and_grads``'s gradients bit for bit (PyTorch's
    deterministic algorithms on, as above)."""
    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    model = zoo.build(cfg, "cpu")
    shapes, axes = model.abstract_params()
    mesh = _cpu_mesh((4, 2))
    sp = tshd.place_tree(model.init(0),
                         tshd.tree_shardings(axes, shapes, mesh))
    batch = _reduced_batch(cfg, 8, 64)
    with _deterministic():
        blocks, loss = steps.row_grads(model, sp, batch)
        ls, _, gs = steps.sharded_loss_and_grads(model, sp, batch)
    held = {pos: 0 for pos in np.ndindex(4, 2)}
    want = {pos: 0 for pos in np.ndindex(4, 2)}
    whole = 0
    for name, p in zoo.flatten(sp):
        sh, block = p.sharding, p.sharding.shard_shape(p.shape)
        whole += p.numel() * p.dtype.itemsize
        firsts = [pos for pos in sh.positions() if sh.is_first_copy(pos)]
        bufs = blocks[name]
        assert sorted(bufs) == sorted(firsts), name
        for pos, g in bufs.items():
            assert tuple(g.shape) == block, (name, pos)
            assert g.device == sh.device(pos)
            nbytes = g.untyped_storage().nbytes()
            assert nbytes == g.numel() * g.element_size(), (name, pos)
            held[pos] += nbytes
            want[pos] += int(np.prod(block)) * p.dtype.itemsize
    assert held == want
    assert max(held.values()) <= whole // 8 + whole // 50, (held, whole)
    mine = steps._grad_tree(sp, blocks)
    assert float(ls) == float(loss)
    for (name, a), (_, b) in zip(zoo.flatten(mine), zoo.flatten(gs)):
        for pos in a.sharding.positions():
            assert torch.equal(a.local(pos), b.local(pos)), (name, pos)


def test_dryrun_smoke_subprocess():
    """The reference's tiny end-to-end dry-run in both packages: reduced
    llama3.2-3b with ``grad_accum`` 2, ``ShapeSpec("t", 128, 8, "train")``
    on a (4, 2) mesh — the reference lowered and compiled over 8 forced
    host devices in a subprocess (its loop-aware ``analyze``), the port
    traced on a mesh of 8 meta devices (``steps.lower_cell``).  Both end
    ``ok`` with dot FLOPs; the port's summed over its 8 positions is
    within 15% of 8 × the reference's per-device count.  What may differ:
    the attention's dots (both count QKᵀ and P·V in full here, S·T under
    the blockwise threshold), the embedding (a gather in both, no dot),
    and remat (off in the reduced configs; on, the port counts the
    recomputed forward, which XLA may merge)."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json, jax
        from repro.configs import get_config, reduced_for_smoke
        from repro.configs.base import ShapeSpec
        from repro.models import zoo
        from repro.launch.mesh import make_host_mesh
        from repro.launch.steps import lower_cell
        from repro.launch.hlo_analysis import analyze
        import dataclasses as dc
        cfg = dc.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                         grad_accum=2)
        model = zoo.build(cfg)
        mesh = make_host_mesh(8, model=2)
        shape = ShapeSpec("t", 128, 8, "train")
        compiled = lower_cell(model, shape, mesh).compile()
        la = analyze(compiled.as_text())
        assert la["dot_flops"] > 0
        print(json.dumps({"ok": True, "flops": la["dot_flops"]}))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref["ok"] is True
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              grad_accum=2)
    mesh = Mesh(np.array([torch.device("meta")] * 8,
                         dtype=object).reshape(4, 2), ("data", "model"))
    acc = steps.lower_cell(zoo.build(cfg, "meta"),
                           ShapeSpec("t", 128, 8, "train"), mesh)
    rec = acc.record
    assert rec["loop_aware"]["dot_flops"] > 0
    total = sum(p["dot_flops"] for p in rec["positions"])
    want = 8 * ref["flops"]
    assert abs(total - want) <= 0.15 * want, (total, want)


def _jflat(tree):
    import jax
    return {".".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("mesh_name", sorted(STAND_INS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_specs_match_reference_resolve(arch, mesh_name):
    """``prefill_specs`` and ``decode_specs`` (under ``serve_mode`` where
    the config serves weights-resident, as ``lower_cell`` calls it) at the
    config's serving shapes: the arguments' shapes the reference's, and
    every parameter's, input's, cache leaf's and the logits' spec equal to
    the reference's ``resolve`` of its axes and shape — the cache laid
    out by the reference's ``cache_axes`` — in and out."""
    import contextlib
    from repro_torch.configs.base import SHAPES
    mesh = STAND_INS[mesh_name]
    cfg, jcfg = get_config(arch), jget_config(arch)
    smodel = steps.serving_model(cfg, device="cpu")
    jm = jzoo.build(jcfg)
    ref_shapes, ref_axes = _ref_tree(arch)
    for name in SERVE_SHAPES:
        if name not in cfg.shapes():
            continue
        shape = SHAPES[name]
        jshape = JShapeSpec(name, shape.seq_len, shape.global_batch,
                            shape.kind)
        jspec = jzoo.input_specs(jcfg, jshape)
        B, max_len = shape.global_batch, shape.seq_len
        resident = shape.kind == "decode" and cfg.serve_weights_resident
        ctx = (tshd.serve_mode, jshd.serve_mode) if resident else \
            (contextlib.nullcontext, contextlib.nullcontext)
        with ctx[0]():
            sp = (steps.prefill_specs if shape.kind == "prefill"
                  else steps.decode_specs)(smodel, shape, mesh)
        with ctx[1]():
            want_p = {k: tuple(jshd.resolve(ref_axes[k], ref_shapes[k],
                                            mesh)) for k in ref_axes}
            c_axes = _jflat(jm.cache_axes())
            c_shapes = {k: tuple(v.shape) for k, v in
                        _jflat(jm.abstract_cache(B, max_len)).items()}
            want_c = {k: tuple(jshd.resolve(c_axes[k], c_shapes[k], mesh))
                      for k in c_axes}
            want_l = tuple(jshd.resolve("batch|seq|vocab",
                                        (B, 1, cfg.vocab), mesh))
            want_b = {k: tuple(jshd.resolve(jspec["axes"][k],
                                            jspec["batch"][k].shape, mesh))
                      for k in jspec["axes"]}
        p_sh = sp["in_shardings"][0]
        assert {k: v.spec for k, v in zoo.flatten(p_sh)} == want_p, name
        cache_sh, logits_sh = sp["out_shardings"]
        assert {k: v.spec for k, v in zoo.flatten(cache_sh)} == want_c
        assert logits_sh.spec == want_l
        if shape.kind == "prefill":
            assert {k: v.spec for k, v in
                    sp["in_shardings"][1].items()} == want_b
            assert sp["max_len"] == jspec["max_len"]
        else:
            assert sp["in_shardings"][1] == cache_sh
            assert sp["in_shardings"][2].spec == want_b["token"]
            assert {k: tuple(t.shape) for k, t in
                    zoo.flatten(sp["args"][1])} == c_shapes
            assert sp["donate_argnums"] == (1,)


SERVE_ARCHS = ["llama3.2-3b", "qwen3-moe-30b-a3b", "paligemma-3b",
               "mamba2-1.3b", "zamba2-7b:5", "whisper-medium"]


def _serve_case(arch, B, S):
    """Reduced ``arch`` (``name:layers`` for another depth), its reference
    parameters carried across, a batch of B prompts of S positions."""
    import jax
    from repro.configs import reduced_for_smoke as jreduced
    from repro.models.base import tree_unbox
    arch, _, depth = arch.partition(":")
    jcfg, cfg = jreduced(jget_config(arch)), reduced_for_smoke(
        get_config(arch))
    if depth:
        jcfg = dataclasses.replace(jcfg, n_layers=int(depth))
        cfg = dataclasses.replace(cfg, n_layers=int(depth))
    jparams, _ = tree_unbox(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S - cfg.n_patches))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embs"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return jcfg, tree, cfg, batch


def _held_blocks(tree):
    """Positions of ``tree``'s ``ShardedTensor`` leaves holding other than
    their spec's block (shape or storage)."""
    off = []
    for name, t in zoo.flatten(tree):
        block = t.sharding.shard_shape(t.shape)
        for pos in t.sharding.positions():
            loc = t.local(pos)
            if tuple(loc.shape) != block or loc.untyped_storage().nbytes() \
                    != loc.numel() * loc.element_size():
                off.append((name, pos))
    return off


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _serve_mesh_run(arch, B, S, mesh_shape, steps_n=2):
    """The sharded prefill and ``steps_n`` greedy decode steps of reduced
    ``arch`` over a mesh of repeated CPU devices, and each data row's
    batch rows run alone, unsharded; the reference's prefill and one
    decode step on the whole batch."""
    import jax
    import jax.numpy as jnp
    jcfg, tree, cfg, batch = _serve_case(arch, B, S)
    model = zoo.build(cfg, "cpu")
    params = zoo.params_from_numpy(cfg, tree, "cpu")
    max_len = S + 4
    mesh = _cpu_mesh(mesh_shape)
    shapes, axes = model.abstract_params()
    sp = tshd.place_tree(params, tshd.tree_shardings(axes, shapes, mesh))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pre = steps.build_prefill_step(model, max_len)
    dec = steps.build_decode_step(model)
    cache, lg = pre(sp, tbatch)
    logits, toks = [lg], []
    for _ in range(steps_n):
        toks.append(logits[-1].full().argmax(-1).to(torch.int32))
        cache, lg = dec(sp, cache, toks[-1])
        logits.append(lg)
    jm = jzoo.build(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jcache, jlog = jm.prefill(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, max_len)
    _, jdec = jm.decode(jp, jcache, jnp.asarray(toks[0].numpy()))
    return dict(cfg=cfg, model=model, params=params, sp=sp, mesh=mesh,
                batch=tbatch, max_len=max_len, cache=cache, logits=logits,
                toks=toks, jlog=np.asarray(jlog), jdec=np.asarray(jdec),
                jcache=jax.tree_util.tree_map(np.asarray, jcache))


def _rows_alone(run, spans):
    """Each span of batch rows run alone on one device through the same
    greedy tokens: (its logits of every step, its final cache)."""
    model, pre = run["model"], steps.build_prefill_step(run["model"],
                                                         run["max_len"])
    dec = steps.build_decode_step(model)
    out = []
    for span in spans:
        cache, lg = pre(run["params"], {k: v[span] for k, v in
                                        run["batch"].items()})
        logs = [lg]
        for tok in run["toks"]:
            cache, lg = dec(run["params"], cache, tok[span])
            logs.append(lg)
        out.append((logs, cache))
    return out


def _same(got, want, exact: bool):
    """Equal bit for bit, or (``exact`` False) within 1e-5 of the largest
    entry."""
    if exact:
        return torch.equal(got, want)
    return _rel_max(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_rows_alone(arch):
    """Every family's prefill and two greedy decode steps over a (2, 2)
    mesh of repeated CPU devices (``build_prefill_step`` /
    ``build_decode_step`` on ``ShardedTensor`` parameters): each data
    row's logits and its rows of every cache leaf equal the unsharded
    steps run on that row's batch rows alone — bit for bit where the row
    computes whole layers (MoE, SSM, hybrid, enc-dec), within 1e-5 of the
    largest entry where its positions compute their ``model`` shares
    (dense, VLM: the sums over ``model`` add in another order); the
    prefill's logits and cache and the first decode step's logits within
    1e-4 of the largest of the reference's (parameters carried across with
    ``params_from_numpy``); every position holds exactly its blocks of the
    parameters, the cache (laid out by ``cache_axes``) and the logits, and
    ``len`` on every position."""
    _serve_rows_alone(arch, (2, 2))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "paligemma-3b"])
def test_sharded_serving_without_model_split_is_rows_alone(arch):
    """``test_sharded_prefill_and_decode_match_rows_alone`` of the
    tensor-parallel families on a (2, 1) mesh: one position a data row,
    the tensor-parallel layout a no-op, each row's logits and cache the
    rows alone bit for bit."""
    _serve_rows_alone(arch, (2, 1))


def _serve_rows_alone(arch, mesh_shape):
    from repro_torch.models import tensor_parallel as TP
    run = _serve_mesh_run(arch, 4, 24, mesh_shape)
    model, cache = run["model"], run["cache"]
    exact = model.cfg.family not in TP.FAMILIES or mesh_shape[1] == 1
    c_axes = dict(zoo.flatten(model.cache_axes()))
    spans = [slice(0, 2), slice(2, 4)]
    for span, (logs, alone) in zip(spans, _rows_alone(run, spans)):
        for got, want in zip(run["logits"], logs):
            assert _same(got.full()[span], want, exact), (arch, span)
        for name, leaf in zoo.flatten(cache):
            full = leaf.full()
            want = dict(zoo.flatten(alone))[name]
            if name == "len":
                assert torch.equal(full, want)
                continue
            dim = c_axes[name].split("|").index("batch")
            assert _same(full.narrow(dim, span.start, 2), want, exact), name
    assert _rel_max(run["logits"][0].numpy(), run["jlog"]) < 1e-4
    assert _rel_max(run["logits"][1].numpy(), run["jdec"]) < 1e-4
    jprefill = _serve_mesh_prefill_cache(run)
    for name, want in zoo.flatten(run["jcache"]):
        if name != "len" and want.size:
            assert _rel_max(jprefill[name], want) < 1e-4, name
    assert not _held_blocks(run["sp"]) and not _held_blocks(cache)
    assert not _held_blocks({"logits": run["logits"][-1]})
    n = run["batch"]["tokens"].shape[1] + run["cfg"].n_patches + 2
    assert {int(cache["len"].local(p)) for p in
            cache["len"].sharding.positions()} == {n}


def _serve_mesh_prefill_cache(run):
    """The sharded prefill's cache alone, as numpy leaves."""
    cache, _ = steps.build_prefill_step(run["model"], run["max_len"])(
        run["sp"], run["batch"])
    return {k: v.numpy() for k, v in zoo.flatten(cache)}


def test_sharded_serving_replicates_a_batch_that_does_not_split():
    """Batch 1 over a (2, 2) mesh: the reference replicates the batch and
    puts ``kv_seq`` on (data, model), so every data row computes the one
    prompt and writes its data row's blocks of the cache; the logits and
    the cache equal the unsharded steps' bit for bit and the reference's
    within 1e-4, and each position holds a quarter of the cache's
    positions."""
    run = _serve_mesh_run("llama3.2-3b", 1, 28, (2, 2))
    assert run["cache"]["kv"]["k"].sharding.spec == \
        (None, None, ("data", "model"), None, None)
    (logs, alone), = _rows_alone(run, [slice(0, 1)])
    for got, want in zip(run["logits"], logs):
        assert torch.equal(got.full(), want)
    for (name, leaf), (_, want) in zip(zoo.flatten(run["cache"]),
                                       zoo.flatten(alone)):
        assert torch.equal(leaf.full(), want), name
    assert _rel_max(run["logits"][0].numpy(), run["jlog"]) < 1e-4
    assert _rel_max(run["logits"][1].numpy(), run["jdec"]) < 1e-4
    k = run["cache"]["kv"]["k"]
    assert k.local((1, 1)).shape[2] == run["max_len"] // 4
    assert not _held_blocks(run["cache"])


# ---------------------------------------------------------------------------
# Subprocess cells: both packages under one forced host device count
# ---------------------------------------------------------------------------

_PRELUDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%d" % NDEV)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, "tests")
    import json, threading, time
    import numpy as np, jax, torch

    from repro.core import fm as jfm, materialize as jmz
    from repro.core.fusion import Plan as JPlan
    from repro.core.matrix import DenseStore as JDenseStore
    from repro.core.matrix import FMMatrix as JFMMatrix
    from repro.launch.mesh import make_host_mesh
    from repro.observability import metrics as jmetrics
    from repro import storage as jstorage
    from repro_torch.core import fm as tfm, materialize as tmz
    from repro_torch.core.fusion import Plan as TPlan
    from repro_torch.core.matrix import DenseStore as TDenseStore
    from repro_torch.core.matrix import FMMatrix as TFMMatrix
    from repro_torch.launch.mesh import Mesh
    from repro_torch.observability import metrics as tmetrics
    from repro_torch import storage as tstorage

    assert len(jax.devices()) == NDEV
    tfm.set_conf(device="cpu")

    class Side:
        def __init__(self, name, fm, mz, Plan, DenseStore, FMMatrix,
                     metrics, storage, backend, mesh):
            self.name, self.fm, self.mz, self.Plan = name, fm, mz, Plan
            self.DenseStore, self.FMMatrix = DenseStore, FMMatrix
            self.metrics, self.storage = metrics, storage
            self.backend, self.mesh = backend, mesh

    def port_mesh(shape):
        cpu = torch.device("cpu")
        devs = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            devs[idx] = cpu
        return Mesh(devs, ("data", "model"))

    COUNTERS = ("shards", "shard_merges", "streams", "passes",
                "partition_steps", "epilogue_launches")

    def snap(S):
        st = S.mz.exec_stats()
        out = {k: st[k] for k in COUNTERS}
        out["bytes_streamed"] = int(S.metrics.root_counter("bytes_streamed"))
        return out, st

    def counted(S, fn):
        before, _ = snap(S)
        res = fn()
        after, st = snap(S)
        c = {k: after[k] - before[k] for k in after}
        c["shard_bytes_in"] = list(st["shard_bytes_in"])
        c["pass_bytes_in"] = list(st["pass_bytes_in"])
        return res, c

    def kernels(S, outs):
        plan = S.Plan([o.m for o in outs if o.m.is_virtual])
        kb = "pallas" if S.name == "repro" else "cuda"
        return sorted(u.kernel for u in plan.program(kb).kernel_units)

    def err(got, want):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want))) if got.size else 0.0
""")

_GRID = _PRELUDE + textwrap.dedent("""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(512, 6)).astype(np.float32)
    CASES = ("colMeans", "colSds", "crossprod", "scale")

    def build(S, nm, X):
        return getattr(S.fm, nm)(X)

    def run_side(S):
        fm = S.fm
        rec = {}
        fm.set_conf(io_partition_bytes=2048)
        mesh = S.mesh

        def src(mk):
            X = fm.conv_R2FM(A)
            return fm.persist(X, tier="disk") if mk == "disk" else X

        base = {}
        for mode, mk in (("whole", "mem"), ("stream", "mem"), ("ooc", "disk")):
            X = src(mk)
            base[mode] = [fm.as_np(fm.materialize(build(S, nm, X), mode=mode,
                                                  backend=S.backend)[0])
                          for nm in CASES]
        rec["base"] = {mode: [v.tolist() for v in vals]
                       for mode, vals in base.items()}
        for mode, mk in (("whole", "mem"), ("stream", "mem"), ("ooc", "disk")):
            X = src(mk)
            cells = []
            for nm, want in zip(CASES, base[mode]):
                if mode == "whole":
                    fn = lambda: fm.materialize(build(S, nm, X), mode=mode,
                                                mesh=mesh, backend=S.backend)
                else:
                    def fn():
                        fm.set_conf(mesh=mesh)
                        try:
                            return fm.materialize(build(S, nm, X), mode=mode,
                                                  backend=S.backend)
                        finally:
                            fm.set_conf(mesh=False)
                (out,), c = counted(S, fn)
                have = fm.as_np(out)
                cells.append({"case": nm, "counters": c,
                              "err": err(have, want),
                              "ok": bool(np.allclose(want, have, rtol=1e-4,
                                                     atol=1e-4)),
                              "kernels": kernels(S, [build(S, nm, X)])})
            rec[mode] = cells

        fm.set_conf(mesh=mesh)
        X = fm.conv_R2FM(A)
        (g,), c = counted(S, lambda: fm.materialize(
            fm.crossprod(X), mode="stream", backend=S.backend))
        rec["solo"] = {"counters": c, "err": err(fm.as_np(g), A.T @ A),
                       "ok": bool(np.allclose(fm.as_np(g), A.T @ A,
                                              rtol=1e-4, atol=1e-3))}

        D = fm.persist(fm.conv_R2FM(A), tier="disk")
        (Sd,), c = counted(S, lambda: fm.materialize(
            fm.scale(D, save="disk"), mode="ooc", backend=S.backend))
        ref = (A - A.mean(0)) / A.std(0, ddof=1)
        rec["spill"] = {"counters": c, "err": err(fm.as_np(Sd), ref),
                        "ok": bool(np.allclose(fm.as_np(Sd), ref, rtol=1e-3,
                                               atol=1e-3)),
                        "on_disk": bool(Sd.m.on_disk)}

        X = fm.conv_R2FM(A)
        (means, (sds, ctp)), c = counted(S, lambda: fm.batch(
            fm.colMeans(X), (fm.colSds(X), fm.crossprod(X)), mode="stream",
            backend=S.backend))
        rec["batch"] = {
            "counters": c,
            "err_ctp": err(fm.as_np(ctp), A.T @ A),
            "ok": bool(np.allclose(fm.as_np(means), A.mean(0), atol=1e-4)
                       and np.allclose(fm.as_np(ctp), A.T @ A, rtol=1e-4,
                                       atol=1e-3))}

        class FlakyStore(S.DenseStore):
            def __init__(self, data, fail_after):
                super().__init__(np.asarray(data))
                self.fail_after = fail_after
                self.reads = 0
                self._lk = threading.Lock()

            def block(self, start, stop):
                with self._lk:
                    self.reads += 1
                    n = self.reads
                if n > self.fail_after:
                    raise RuntimeError("injected shard staging failure")
                return super().block(start, stop)

        n_threads0 = threading.active_count()
        Xf = S.FMMatrix(A.shape, A.dtype, store=FlakyStore(A, 2),
                        name="flaky")
        G = fm.crossprod(fm.FM(Xf) * 2.0)
        raised = False
        try:
            fm.materialize(G, mode="stream", backend=S.backend)
        except RuntimeError:
            raised = True
        deadline = time.time() + 10
        while time.time() < deadline and (
                S.storage.live_prefetchers() or
                threading.active_count() > n_threads0):
            time.sleep(0.05)
        rec["flaky"] = {
            "raised": raised, "virtual": bool(G.m.is_virtual),
            "cached": getattr(G.m, "cached_store", None) is not None,
            "live": len(S.storage.live_prefetchers()),
            "staged": len(S.storage.staged_leaks()),
            "no_thread_left": threading.active_count() <= n_threads0,
            "shard_threads": [t.name for t in threading.enumerate()
                              if t.name.startswith("fm-shard")]}
        fm.set_conf(mesh=False)
        return rec

    out = {}
    for S in (Side("repro", jfm, jmz, JPlan, JDenseStore, JFMMatrix,
                   jmetrics, jstorage, "xla", make_host_mesh(NDEV)),
              Side("repro_torch", tfm, tmz, TPlan, TDenseStore, TFMMatrix,
                   tmetrics, tstorage, "torch", port_mesh((NDEV, 1)))):
        S.fm.reset_exec_stats()
        out[S.name] = run_side(S)
    print(json.dumps(out))
""")


def _run(script: str, ndev: int) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", f"NDEV = {ndev}\n" + script],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_parity_grid(ndev):
    """Sharded materialize == unsharded across algorithms × modes under
    1/2/8 shards in both packages, with the shard accounting exact and
    equal to the reference's; a spill lands in one store, a batch shards
    its one stream, and an interrupted shard registers nothing and leaks
    no prefetcher, staged partition or shard thread."""
    got = _run(_GRID, ndev)
    ref, port = got["repro"], got["repro_torch"]
    for mode in ("whole", "stream", "ooc"):
        # the unsharded baselines agree across packages
        for r, t in zip(ref["base"][mode], port["base"][mode]):
            np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-4)
        for rc, tc in zip(ref[mode], port[mode]):
            assert tc["counters"] == rc["counters"], (mode, tc, rc)
            assert tc["kernels"] == rc["kernels"], (mode, tc, rc)
            for side in (rc, tc):
                assert side["ok"], (mode, side)
            if mode != "whole":
                sh = tc["counters"]["shards"]
                assert sh > 0 and sh % ndev == 0, (mode, tc)
    for cell in ("solo", "spill", "batch"):
        assert port[cell]["counters"] == ref[cell]["counters"], \
            (cell, port[cell], ref[cell])
    solo = port["solo"]["counters"]
    assert solo["shards"] == ndev and solo["shard_merges"] == ndev - 1
    assert len(solo["shard_bytes_in"]) == ndev
    assert sum(solo["shard_bytes_in"]) == 512 * 6 * 4
    for side in (ref, port):
        assert side["solo"]["ok"], side["solo"]
        assert side["spill"]["on_disk"] and side["spill"]["ok"]
        b = side["batch"]
        assert b["counters"]["streams"] == 1
        assert b["counters"]["shards"] == ndev
        assert b["ok"], b
    assert port["flaky"] == ref["flaky"], (port["flaky"], ref["flaky"])
    assert port["flaky"]["raised"] and port["flaky"]["virtual"]
    assert not port["flaky"]["cached"]
    assert port["flaky"]["live"] == port["flaky"]["staged"] == 0
    assert port["flaky"]["no_thread_left"]
    assert port["flaky"]["shard_threads"] == []


_EQUIV = _PRELUDE + textwrap.dedent("""
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(512, 6)).astype(np.float32)
    out = {}
    for S in (Side("repro", jfm, jmz, JPlan, JDenseStore, JFMMatrix,
                   jmetrics, jstorage, "xla", make_host_mesh(8, model=2)),
              Side("repro_torch", tfm, tmz, TPlan, TDenseStore, TFMMatrix,
                   tmetrics, tstorage, "torch", port_mesh((4, 2)))):
        X = S.fm.conv_R2FM(Xn)
        (g, s), c = counted(S, lambda: S.fm.materialize(
            S.fm.crossprod(X), S.fm.colSums(X), mesh=S.mesh,
            backend=S.backend))
        g, s = S.fm.as_np(g), S.fm.as_np(s).ravel()
        out[S.name] = {
            "counters": c,
            "kernels": kernels(S, [S.fm.crossprod(X), S.fm.colSums(X)]),
            "gram_ok": bool(np.allclose(g, Xn.T @ Xn, rtol=1e-3)),
            "sums_ok": bool(np.allclose(s, Xn.sum(0), rtol=1e-3)),
            "gram": g.tolist()}

    # 2) a sharded train step against one device (reduced llama3.2-3b)
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced_for_smoke as jred
    from repro.models import zoo as jzoo
    from repro.models.base import tree_unbox
    from repro.distributed import sharding as jshd
    from repro.launch.steps import build_train_step as jbuild
    from repro.optim import adam as jadam
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.distributed import sharding as tshd
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import zoo as tzoo
    from repro_torch.optim import adam as tadam

    mesh = make_host_mesh(8, model=2)
    jcfg = jred(jget("llama3.2-3b"))
    jmodel = jzoo.build(jcfg)
    params, axes = tree_unbox(jmodel.init(jax.random.PRNGKey(0)))
    toks = rng.integers(0, jcfg.vocab, (8, 64)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab, (8, 64)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    jstep = jbuild(jmodel)
    loss_1dev = jax.jit(jstep)(params, jadam.init(params), batch)[2]["loss"]
    with jshd.use_mesh(mesh):
        shapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
        p_sh = jshd.tree_shardings(axes, shapes, mesh)
        params_s = jax.tree_util.tree_map(jax.device_put, params, p_sh)
        b_sh = {k: jshd.sharding_for("batch|seq", v.shape, mesh)
                for k, v in batch.items()}
        batch_s = {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()}
        loss_8dev = jax.jit(jstep)(params_s, jadam.init(params_s),
                                   batch_s)[2]["loss"]
    train = {"repro": {"loss_1dev": float(loss_1dev),
                       "loss_8dev": float(loss_8dev)}}

    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    model = tzoo.build(cfg, "cpu")
    host = jax.tree_util.tree_map(np.asarray, params)
    tparams = tzoo.params_from_numpy(cfg, host, "cpu")
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labs)}
    l1, _, g1 = tsteps.loss_and_grads(model, tparams, tbatch)
    g1 = {k: v.clone() for k, v in tzoo.flatten(g1)}
    tmesh = port_mesh((4, 2))
    shapes_t, axes_t = model.abstract_params()
    sparams = tshd.place_tree(tzoo.params_from_numpy(cfg, host, "cpu"),
                              tshd.tree_shardings(axes_t, shapes_t, tmesh))
    rows = tshd.sharding_for("batch|seq", (8, 64), tmesh)
    sbatch = {k: tshd.place(v, rows) for k, v in tbatch.items()}
    l8, _, g8 = tsteps.sharded_loss_and_grads(model, sparams, sbatch)
    err = max(float((g.full() - g1[k]).abs().max() / g1[k].abs().max())
              for k, g in tzoo.flatten(g8))
    step = tsteps.build_train_step(model)
    _, _, met = step(sparams, tadam.init(sparams), sbatch)
    train["repro_torch"] = {
        "loss_1dev": float(l1), "loss_8dev": float(met["loss"]),
        "grads_loss": float(l8), "grad_rel_err": err,
        "on_mesh": all(v.sharding.mesh == tmesh
                       for _, v in tzoo.flatten(sparams))}
    out["train"] = train
    print(json.dumps(out))
""")


def test_multidevice_equivalence():
    """The reference's test in both packages.  Part 1: data-parallel GenOps
    in whole mode over an 8-device (4, 2) data × model mesh equal the host
    reference; the port over ``[cpu] × 8`` with the same shape shards its
    rows 4 ways (the model axis replicates) with the reference's counters.
    Part 2: one train step of reduced llama3.2-3b, batch 8 × 64, on the
    (4, 2) mesh: the port's loss within 1e-3 relative of the reference's
    8-device loss and of its own one-device loss (the reference test's
    bound), its gradients within 1e-5 of each leaf's largest entry of the
    one-device ones, and the reference's two losses within its own 1e-3."""
    got = _run(_EQUIV, 8)
    train = got.pop("train")
    for name in ("repro", "repro_torch"):
        one, mesh = train[name]["loss_1dev"], train[name]["loss_8dev"]
        assert abs(one - mesh) / abs(one) < 1e-3, (name, one, mesh)
    port_mesh_loss = train["repro_torch"]["loss_8dev"]
    ref_mesh_loss = train["repro"]["loss_8dev"]
    assert abs(port_mesh_loss - ref_mesh_loss) / abs(ref_mesh_loss) < 1e-3
    assert train["repro_torch"]["grad_rel_err"] <= 1e-5, train
    assert train["repro_torch"]["on_mesh"]
    ref, port = got["repro"], got["repro_torch"]
    assert port["counters"] == ref["counters"], (port, ref)
    assert port["counters"]["shards"] == 4
    assert port["kernels"] == ref["kernels"]
    for side in (ref, port):
        assert side["gram_ok"] and side["sums_ok"]
    np.testing.assert_allclose(port["gram"], ref["gram"], rtol=1e-4,
                               atol=1e-3)
