"""The sharded train step on a batch that does not split over the data
rows (the port's ``launch.steps.sharded_loss_and_grads``), held against
the reference's GSPMD step and against the port's own one-device step.

The reference's batch layout (``resolve``) replicates a batch dimension
that does not divide the data axis, and GSPMD computes that batch on every
data row; the port's step does the same microbatch by microbatch: a
microbatch that splits evenly over the data rows is split, one that does
not is computed whole by every row, each row's part weighed 1/n_rows.

* The reference: one subprocess (XLA's forced host device count must be
  set before JAX starts) runs ``value_and_grad`` of the forward, ``jax.jit``
  with the reference's shardings, of reduced llama3.2-3b on 8 × 24 tokens
  over ``replan_mesh(12, prefer_model=16)`` = (data 3, model 4) — the
  elastic restore onto 12 of 16 hosts — and of each of the six families
  on 4 rows over ``make_host_mesh(6, model=2)`` = (3, 2), and calls its
  train step on 9 rows with ``grad_accum`` 2; the port runs the same
  parameters (``zoo.params_from_numpy``) over meshes of repeated CPU
  devices of the same shapes: the loss within 1e-5 relative and every
  gradient leaf within 1e-5 of its largest entry.
  A masked MoE case (``MASKED``), qwen3-moe-30b-a3b on 6 rows over
  (3, 2), splits 2 rows a data row under a ``loss_mask`` of about 60% of
  the tokens with data row 1's rows masked out.
* The port's one-device step, at the same ``grad_accum``: the same within
  1e-5, where the whole batch does not split, where it splits but a
  microbatch does not, and with a ``loss_mask`` — the MoE families' too
  on rows that split a microbatch, a data row's rows masked out or not;
  a MoE layer's load-balancing term on every row equal to one device's,
  and on split rows under a mask, each row's weighed by its share of the
  tokens, summing to one device's, a row whose mask is empty adding its
  part.
* A batch that does not reshape into ``grad_accum`` microbatches raises in
  both packages; each position holds one gradient block a leaf, bit for
  bit run to run; a traced step of such a cell counts row 0's whole batch.
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
from repro_torch.models import moe, zoo
from repro_torch.runtime import replan_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FAMILIES = ["llama3.2-3b", "paligemma-3b", "qwen3-moe-30b-a3b",
            "whisper-medium", "mamba2-1.3b", "zamba2-7b"]
S = 24                 # positions a row (the SSM's chunks stay in range)
#: case -> (config, batch rows, the reference's mesh)
CASES = {"c8": ("llama3.2-3b", 8, "replan12"),
         **{arch: (arch, 4, "host6") for arch in FAMILIES},
         "c9": ("qwen3-moe-30b-a3b", 6, "host6")}
#: case -> the data row whose rows its ``loss_mask`` masks out (a mask of
#: about 60% of the tokens elsewhere)
MASKED = {"c9": 1}
TOL = 1e-5

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses, json
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config, reduced_for_smoke
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train_step
    from repro.models import zoo
    from repro.models.base import tree_unbox
    from repro.optim import adam
    from repro.runtime import replan_mesh

    cases, masked, S, out = json.loads(sys.argv[1])
    meshes = {"replan12": replan_mesh(12, prefer_model=16),
              "host6": make_host_mesh(6, model=2)}
    res = {}

    def flat(tree, prefix):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(str(k.key) for k in path)
            res[f"{prefix}:{name}"] = np.asarray(v, np.float32)

    def setup(arch, accum=1):
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                                  grad_accum=accum)
        model = zoo.build(cfg)
        return cfg, model, *tree_unbox(model.init(jax.random.PRNGKey(0)))

    for name, (arch, rows, mesh_name) in cases.items():
        mesh = meshes[mesh_name]
        cfg, model, params, axes = setup(arch)
        rng = np.random.default_rng(5)
        text = S - cfg.n_patches
        batch = {k: rng.integers(0, cfg.vocab, (rows, text)).astype(np.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["patch_embs"] = rng.normal(
                size=(rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
        if name in masked:
            mask = (rng.random((rows, text)) < 0.6).astype(np.float32)
            n = mesh.shape["data"]
            mask[masked[name] * rows // n:(masked[name] + 1) * rows // n] = 0
            batch["loss_mask"] = mask
        for k, v in batch.items():
            res[f"{name}:batch:{k}"] = v
        flat(params, f"{name}:params")
        res[f"{name}:mesh"] = np.asarray(mesh.devices.shape)
        with shd.use_mesh(mesh):
            p_sh = jax.tree_util.tree_map(
                lambda ax, t: shd.sharding_for(ax, t.shape, mesh), axes,
                params)
            b_sh = {k: shd.sharding_for("batch|seq" if v.ndim == 2
                                        else "batch|seq|embed", v.shape, mesh)
                    for k, v in batch.items()}
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: model.forward(p, b)[0]),
                in_shardings=(p_sh, b_sh))
            loss, g = grad(jax.device_put(params, p_sh),
                           jax.device_put({k: jnp.asarray(v) for k, v in
                                           batch.items()}, b_sh))
        res[f"{name}:loss"] = np.asarray(loss)
        flat(g, f"{name}:grad")

    cfg, model, params, _ = setup("llama3.2-3b", accum=2)
    nine = jnp.zeros((9, S), jnp.int32)
    try:
        build_train_step(model)(params, adam.init(params),
                                {"tokens": nine, "labels": nine})
        raised = ""
    except Exception as exc:
        raised = type(exc).__name__
    np.savez(out, **res)
    print(json.dumps({"ok": True, "raised": raised}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case of ``CASES`` (one
    subprocess), keyed ``case:what[:leaf]``, and ``raised``: the error
    its train step raised on 9 rows with ``grad_accum`` 2."""
    out = str(tmp_path_factory.mktemp("batch") / "ref.npz")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps([CASES, MASKED, S, out])],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    head = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out) as f:
        return dict(f.items(), raised=head["raised"])


def _cpu_mesh(shape):
    return Mesh(np.array([CPU] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
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


def _cfg(arch, accum=1):
    return dataclasses.replace(reduced_for_smoke(get_config(arch)),
                               grad_accum=accum)


def _case(ref, name, accum=1):
    """(model, port parameters, batch) of case ``name`` from the
    reference's run, at ``grad_accum`` ``accum``."""
    cfg = _cfg(CASES[name][0], accum)
    pre = f"{name}:params:"
    tree = _unflat({k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)})
    pre = f"{name}:batch:"
    batch = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items()
             if k.startswith(pre)}
    return (zoo.build(cfg, "cpu"), zoo.params_from_numpy(cfg, tree, "cpu"),
            batch)


def _seeded(arch, rows, accum=1, mask=False, seed=7, empty=()):
    """(model, seeded parameters, a batch of ``rows``) of reduced
    ``arch``, with a ``loss_mask`` of about 60% of the tokens if asked,
    0 on the batch rows ``empty``."""
    cfg = _cfg(arch, accum)
    model = zoo.build(cfg, "cpu")
    rng = np.random.default_rng(seed)
    text = S - cfg.n_patches

    def draw(*shape, ints=False):
        v = rng.integers(0, cfg.vocab, shape).astype(np.int32) if ints \
            else rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(v)
    batch = {k: draw(rows, text, ints=True) for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embs"] = draw(rows, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        batch["frames"] = draw(rows, cfg.enc_len, cfg.d_model)
    if mask:
        m = (rng.random((rows, text)) < 0.6).astype(np.float32)
        m[list(empty)] = 0
        batch["loss_mask"] = torch.from_numpy(m)
    return model, model.init(0), batch


def _row_rows(rows, accum, data_row, n_data) -> list:
    """The batch rows data row ``data_row`` of ``n_data`` computes where
    every microbatch splits over them: its block of each microbatch."""
    m = rows // accum
    per = m // n_data
    return [i * m + data_row * per + j for i in range(accum)
            for j in range(per)]


def _sharded(model, params, mesh):
    shapes, axes = model.abstract_params()
    return shd.place_tree(params, shd.tree_shardings(axes, shapes, mesh))


def _grads(model, params, batch, mesh=None):
    """(loss, {leaf: gradient}) one device, or over ``mesh``."""
    if mesh is None:
        loss, _, g = steps.loss_and_grads(model, params, batch)
        out = {k: v.detach().clone().numpy() for k, v in zoo.flatten(g)}
        for _, p in zoo.flatten(params):
            p.grad = None
            p.requires_grad_(False)
        return float(loss), out
    loss, _, g = steps.sharded_loss_and_grads(
        model, _sharded(model, params, mesh), batch)
    return float(loss), {k: v.numpy() for k, v in zoo.flatten(g)}


def _close(got, want):
    (lg, gg), (lw, gw) = got, want
    assert abs(lg - lw) <= TOL * abs(lw), (lg, lw)
    for name, g in gg.items():
        assert _rel(g, gw[name]) <= TOL, (name, _rel(g, gw[name]))


def _splits(rows, accum, mesh) -> tuple:
    """(whether the batch splits over the mesh's data rows, whether a
    microbatch does)."""
    n = mesh.devices.shape[0]
    return rows % n == 0, (rows // accum) % n == 0


def test_c8_program_matches_reference_gspmd(ref):
    """Fault C8's program: reduced llama3.2-3b, ``PRNGKey(0)``, 8 × 24
    tokens over ``replan_mesh(12, prefer_model=16)`` = (3, 4), the batch
    laid out as the train step's specs lay it out (every row holds it
    whole), against the reference's GSPMD step over 12 forced host
    devices."""
    model, params, batch = _case(ref, "c8")
    mesh = replan_mesh(12, prefer_model=16, devices=[CPU] * 12)
    assert tuple(mesh.devices.shape) == tuple(ref["c8:mesh"]) == (3, 4)
    assert _splits(8, 1, mesh) == (False, False)
    placed = {k: shd.place(v, shd.sharding_for("batch|seq", v.shape, mesh))
              for k, v in batch.items()}
    loss, _, g = steps.sharded_loss_and_grads(
        model, _sharded(model, params, mesh), placed)
    want = {name: ref[f"c8:grad:{name}"] for name, _ in zoo.flatten(params)}
    _close((float(loss), {k: v.numpy() for k, v in zoo.flatten(g)}),
           (float(ref["c8:loss"]), want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_reference_and_one_device(ref, arch):
    """Each family, reduced, 4 rows over (3, 2) positions (the tensor-
    parallel forward, every row computing the whole batch) against the
    reference's GSPMD step over 6 forced host devices and against the
    port's one-device step."""
    model, params, batch = _case(ref, arch)
    mesh = _cpu_mesh((3, 2))
    assert tuple(ref[f"{arch}:mesh"]) == (3, 2)
    got = _grads(model, params, batch, mesh)
    want = {name: ref[f"{arch}:grad:{name}"]
            for name, _ in zoo.flatten(params)}
    _close(got, (float(ref[f"{arch}:loss"]), want))
    _close(got, _grads(model, params, batch))


@pytest.mark.parametrize("arch,rows,accum,shape,mask", [
    ("llama3.2-3b", 8, 2, (3, 2), False),
    ("qwen3-moe-30b-a3b", 8, 2, (3, 2), False),
    ("llama3.2-3b", 12, 2, (4, 1), False),
    ("qwen3-moe-30b-a3b", 12, 2, (4, 1), False),
    ("llama3.2-3b", 8, 2, (3, 2), True),
    ("zamba2-7b", 12, 2, (4, 1), True),
    ("llama3.2-3b", 8, 2, (2, 2), True),
    ("qwen3-moe-30b-a3b", 8, 2, (2, 2), True),
    ("qwen3-moe-30b-a3b", 8, 1, (4, 1), True),
    ("arctic-480b", 8, 2, (2, 2), True),
    ("arctic-480b", 8, 1, (4, 1), True),
    ("qwen3-moe-30b-a3b", 8, 2, (2, 2), "row0"),
    ("qwen3-moe-30b-a3b", 8, 1, (4, 1), "row0")])
def test_grad_accum_matches_one_device(arch, rows, accum, shape, mask):
    """Against one device at the same ``grad_accum``: 8 rows over 3 data
    rows (neither the batch nor a microbatch splits); 12 over 4 with
    microbatches of 6 (the batch splits, a microbatch does not: every row
    computes both whole); with a ``loss_mask``; and masked batches whose
    microbatches do split, over (2, 2) at ``grad_accum`` 2 and (4, 1) at 1,
    where each row's cross-entropy weighs its share of its microbatch's
    mask tokens and a MoE's load-balancing term its share of the tokens —
    with data row 0's rows masked out too (``"row0"``: its cross-entropy
    weighs 0, its balance term still counts)."""
    mesh = _cpu_mesh(shape)
    assert _splits(rows, accum, mesh) == {
        ((3, 2), 4): (False, False), ((4, 1), 6): (True, False),
        ((2, 2), 4): (True, True), ((4, 1), 8): (True, True),
    }[shape, rows // accum]
    empty = _row_rows(rows, accum, 0, shape[0]) if mask == "row0" else ()
    model, params, batch = _seeded(arch, rows, accum, bool(mask),
                                   empty=empty)
    _close(_grads(model, params, batch, mesh), _grads(model, params, batch))


def test_masked_moe_split_matches_reference(ref):
    """Fault C9's semantics against the reference: reduced
    qwen3-moe-30b-a3b, 6 rows over (3, 2) positions (2 rows a data row),
    a ``loss_mask`` of about 60% of the tokens with data row 1's rows
    masked out, against the reference's GSPMD step over 6 forced host
    devices and the port's one-device step: the cross-entropy is the mask's
    mean, the load-balancing term every token's."""
    model, params, batch = _case(ref, "c9")
    mesh = _cpu_mesh((3, 2))
    assert tuple(ref["c9:mesh"]) == (3, 2)
    assert _splits(6, 1, mesh) == (True, True)
    mask = batch["loss_mask"]
    assert not mask[2:4].any() and mask[:2].any() and mask[4:].any()
    got = _grads(model, params, batch, mesh)
    want = {name: ref[f"c9:grad:{name}"] for name, _ in zoo.flatten(params)}
    _close(got, (float(ref["c9:loss"]), want))
    _close(got, _grads(model, params, batch))


@pytest.mark.parametrize("shape", [(3, 2), (3, 1)])
def test_moe_balance_term_on_replicated_rows(shape, monkeypatch):
    """Reduced qwen3-moe-30b-a3b, 4 rows over ``shape`` (tensor-parallel
    over (3, 2), whole layers over (3, 1)): every row computes the whole
    batch, so both sums of a MoE layer's first-choice shares over the rows
    grow 3-fold, and each row's load-balancing term of each layer equals
    one device's within 1e-6."""
    model, params, batch = _seeded("qwen3-moe-30b-a3b", 4)
    terms = {}
    real = moe.balance_loss

    def spy(bal, pe=None):
        out = real(bal, pe)
        terms.setdefault(threading.current_thread().name, []).append(
            float(out.detach()))
        return out
    monkeypatch.setattr(moe, "balance_loss", spy)
    _grads(model, params, batch)
    (one,) = terms.values()
    terms.clear()
    _grads(model, params, batch, _cpu_mesh(shape))
    assert len(one) == model.cfg.n_layers and len(terms) == 3
    for row in terms.values():
        assert len(row) == len(one)
        for got, want in zip(row, one):
            assert abs(got - want) <= 1e-6 * abs(want), (row, one)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_moe_balance_term_by_token_share(shape, monkeypatch):
    """Reduced qwen3-moe-30b-a3b, 8 rows split over ``shape``'s data rows
    under a ``loss_mask`` with data row 1's rows masked out: each row's
    load-balancing term of each layer, weighed by the row's share of the
    tokens, sums over the rows to one device's within 1e-6; and the row
    whose mask is empty adds its part of the router's gradient, with a
    weight above 0."""
    n = shape[0]
    model, params, batch = _seeded("qwen3-moe-30b-a3b", 8, mask=True,
                                   empty=_row_rows(8, 1, 1, n))
    terms, of_thread, router = {}, {}, {}
    real_loss, real_scope = moe.balance_loss, shd.row_scope
    real_add = shd.RowGroup.add_grad

    def spy_loss(bal, pe=None):
        out = real_loss(bal, pe)
        terms.setdefault(threading.current_thread().name, []).append(
            float(out.detach()))
        return out

    def spy_scope(row):
        of_thread[threading.current_thread().name] = row.index
        return real_scope(row)

    def spy_add(self, name, leaf, pos, index, sub, part, row):
        if name == "layers.moe.router":
            router.setdefault(row.index, []).append(
                (self.weights[row.index], float(part.abs().max())))
        return real_add(self, name, leaf, pos, index, sub, part, row)
    monkeypatch.setattr(moe, "balance_loss", spy_loss)
    _grads(model, params, batch)
    (one,) = terms.values()
    terms.clear()
    monkeypatch.setattr(shd, "row_scope", spy_scope)
    monkeypatch.setattr(shd.RowGroup, "add_grad", spy_add)
    _grads(model, params, batch, _cpu_mesh(shape))
    by_row = {of_thread[t]: v for t, v in terms.items()}
    assert sorted(by_row) == list(range(n))
    share = (8 // n) / 8
    for layer, want in enumerate(one):
        got = sum(share * by_row[r][layer] for r in range(n))
        assert abs(got - want) <= 1e-6 * abs(want), (layer, got, want)
    assert not batch["loss_mask"][_row_rows(8, 1, 1, n)].any()
    assert all(t > 0 for t in by_row[1])
    assert router[1] and all(w > 0 and g > 0 for w, g in router[1]), \
        router[1]


def test_batch_not_in_microbatches_raises_in_both(ref):
    """9 rows with ``grad_accum`` 2: the reference's reshape raises, and so
    does the port's sharded step, naming ``grad_accum``."""
    assert ref["raised"], "the reference's step took 9 rows in 2"
    model, params, _ = _seeded("llama3.2-3b", 3, accum=2)
    nine = torch.zeros(9, S, dtype=torch.int32)
    with pytest.raises(ValueError, match="grad_accum=2"):
        steps.sharded_loss_and_grads(
            model, _sharded(model, params, _cpu_mesh((3, 2))),
            {"tokens": nine, "labels": nine})


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def test_one_gradient_block_a_position_bit_for_bit():
    """Reduced llama3.2-3b, 4 rows over (3, 2): after the step each leaf
    has one gradient tensor a block's first copy, of the block's shape and
    storage, and two runs are equal bit for bit."""
    model, params, batch = _seeded("llama3.2-3b", 4)
    sp = _sharded(model, params, _cpu_mesh((3, 2)))
    with _deterministic():
        (b1, l1), (b2, l2) = [steps.row_grads(model, sp, batch)
                              for _ in range(2)]
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


def _dots(shape, rows, every_row=False) -> dict:
    mesh = Mesh(np.array([torch.device("meta")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))
    acc = steps.lower_cell(zoo.build(_cfg("llama3.2-3b"), "meta"),
                           ShapeSpec("t", S, rows, "train"), mesh,
                           every_row=every_row)
    return {tuple(p["pos"]): p["dot_flops"]
            for p in acc.record["positions"]}


def test_traced_step_counts_the_whole_batch_on_each_row():
    """A traced train cell of reduced llama3.2-3b with 4 rows on a (3, 2)
    meta mesh runs, and counts at each position what a (1, 2) mesh's
    position computes for the whole batch — twice what it counts where 6
    rows split in 2 a data row — the same whether row 0 is traced alone
    or every row is."""
    got = _dots((3, 2), 4)
    assert got == _dots((3, 2), 4, every_row=True)
    whole = _dots((1, 2), 4)
    half = _dots((3, 2), 6)
    for pos, f in got.items():
        assert f > 0 and f == whole[(0, pos[1])] == 2 * half[pos], pos
