"""The port's LM training on the CPU against the JAX package.

Reduced llama3.2-3b and qwen2-0.5b (``reduced_for_smoke``: 2 layers,
d_model 128, 4 heads over 2 KV heads, head dim 32, vocab 512, float32), the
reference's parameters from ``model.init(PRNGKey(0))`` carried across with
``params_from_numpy``:

* ``forward``'s loss within 1e-5 relative and every gradient leaf within
  1e-4 of its largest |entry|, remat off and on — for the dense archs and
  for reduced qwen3-moe-30b-a3b and arctic-480b (the loss with 0.01 ·
  aux / n_layers), paligemma-3b (patch embeddings before the text, the
  loss over the text only), mamba2-1.3b (the SSM; 48 tokens take the pad
  path of one chunk) and zamba2-7b (the hybrid at 2 layers, one group and
  an empty tail, and at 5 layers: two applications of the shared block,
  whose leaves add both gradients, and a tail of 1) and whisper-medium
  (enc-dec: frames through the encoder, whose output every decoder
  layer's cross-attention reads);
* ``blockwise_attention``'s forward and its backward (the reference's
  custom VJP through ``jax.vjp``) at B 2, S = T = 48, GQA g = 2, causal and
  not, and not causal over T = 40 != S keys (the enc-dec cross-attention's
  case), bk 16 and bk 20 (T not a multiple: padded keys), within 1e-5 of
  the largest |entry|;
* each route of the train attention (grouped, blockwise) chosen by
  ``_BLOCKWISE_THRESHOLD`` set in both packages, never ``ops.attention``;
* ``adam.update`` on the same numpy gradients: float32 moments and
  parameters within rtol 1e-6, bf16 moments within one bf16 ulp;
* three ``build_train_step`` steps with ``grad_accum`` 1 and 2, for the
  SSM and the hybrid (whose empty tail takes its empty gradient) with 1
  and the config's own, and for the enc-dec with 1: the losses within 1e-5 and the parameters under
  the Adam rule below;
* the launcher's batch: zero float32 ``patch_embs`` for paligemma-3b and
  zero ``frames`` for whisper-medium beside the tokens, every step, the
  keys, shapes and dtypes the reference's launcher feeds its step; and
  after ``--resume`` from the launcher's own checkpoint the same batch
  again, for those two and for mamba2-1.3b (grad_accum 2).

Adam's first steps are close to sign(g): an entry whose gradient is float
noise can move either way by 2·lr.  Entries whose reference gradient is
nonzero and below 1e-5 of its leaf's largest |entry| at some step are
excluded from the parameter comparison, and only those (an embedding row
that no token of the batch reads has a gradient of exactly 0 in both).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_for_smoke as jreduced
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro.models.base import tree_unbox
from repro.optim import adam as jadam
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import layers, zoo
from repro_torch.optim import adam

ARCHS = ["llama3.2-3b", "qwen2-0.5b"]
#: Archs of the loss-and-gradient twin: the dense ones, MoE, the VLM, the
#: SSM and the hybrid (``:5`` sets 5 layers in both packages).
LOSS_ARCHS = ARCHS + ["qwen3-moe-30b-a3b", "arctic-480b", "paligemma-3b",
                      "mamba2-1.3b", "zamba2-7b", "zamba2-7b:5",
                      "whisper-medium"]
B, S = 2, 48


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **over):
    """(reference model, its numpy params, port model, port params)."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **over)
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), **over)
    jm = jzoo.build(jcfg)
    params, _ = tree_unbox(jm.init(jax.random.PRNGKey(0)))
    tree = _np_tree(params)
    return jm, tree, zoo.build(cfg, device="cpu"), zoo.params_from_numpy(
        cfg, tree, "cpu")


def _batch(vocab, b=B, s=S, seed=0, cfg=None):
    """Tokens and labels (b, s); for a VLM ``cfg``, patch embeddings too,
    for an enc-dec one frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    if cfg is not None and cfg.family == "vlm":
        batch["patch_embs"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg is not None and cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_forward_loss_and_grads_match_reference(arch, remat):
    arch, _, layers_ = arch.partition(":")
    over = {"n_layers": int(layers_)} if layers_ else {}
    jm, tree, model, params = _pair(arch, remat=remat, **over)
    batch = _batch(model.cfg.vocab, cfg=model.cfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jm.forward(p, jb), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    for _, p in zoo.flatten(params):
        p.requires_grad_(True)
    loss, met = model.forward(params, _torch(batch))
    loss.backward()
    assert loss.shape == () and set(met) == {"loss"}
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    want = dict(zoo.flatten(_np_tree(jg)))
    for name, p in zoo.flatten(params):
        if p.numel() == 0:                   # the hybrid's empty tail
            assert want[name].size == 0, name
            continue
        assert p.grad.shape == p.shape, name
        assert _rel(p.grad.numpy(), want[name]) < 1e-4, name


@pytest.mark.parametrize("bk", [16, 20])
@pytest.mark.parametrize("causal,T", [pytest.param(True, S, id="True"),
                                      pytest.param(False, S, id="False"),
                                      pytest.param(False, 40, id="False-T40")])
def test_blockwise_attention_matches_reference_vjp(causal, T, bk):
    rng = np.random.default_rng(3)
    nh, nkv, hd = 4, 2, 32
    q = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(B, S, nh * hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jpos, jkpos = jnp.asarray(pos), jnp.asarray(kpos)
    jout, vjp = jax.vjp(lambda q_, k_, v_: jlayers.blockwise_attention(
                            q_, k_, v_, jpos, jkpos, causal, bk),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = layers.blockwise_attention(tq, tk, tv, torch.from_numpy(pos),
                                     torch.from_numpy(kpos), causal, bk)
    out.backward(torch.from_numpy(dout))
    assert _rel(out.detach().numpy(), jout) < 1e-5
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("route", ["grouped", "blockwise"])
def test_train_attention_routes_match_reference(route, monkeypatch):
    """One threshold set in both packages picks the route; the port's train
    attention takes it and never calls ``ops.attention``."""
    threshold = 2048 if route == "grouped" else 16
    from repro.models import layers as jl
    monkeypatch.setattr(jl, "_BLOCKWISE_THRESHOLD", threshold)
    monkeypatch.setattr(layers, "_BLOCKWISE_THRESHOLD", threshold)
    taken = []
    for name in ("blockwise_attention", "_grouped_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **k:
                            taken.append(_n) or _f(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("the train forward reached ops.attention")
    monkeypatch.setattr(ops, "attention", refuse)
    jm, tree, model, params = _pair("llama3.2-3b")
    batch = _batch(model.cfg.vocab, seed=4)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.forward(p, jb), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    for _, p in zoo.flatten(params):
        p.requires_grad_(True)
    loss, _ = model.forward(params, _torch(batch))
    loss.backward()
    want = {"grouped": "_grouped_attention",
            "blockwise": "blockwise_attention"}[route]
    assert taken == [want] * model.cfg.n_layers
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    jgf = dict(zoo.flatten(_np_tree(jg)))
    for name, p in zoo.flatten(params):
        assert _rel(p.grad.numpy(), jgf[name]) < 1e-4, name


def _adam_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"emb": (40, 8), "layers": {"w": (3, 8, 16), "s": (3, 8)},
              "scale": (8,)}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), [draw(10.0 ** -e) for e in (1, 2, 3)]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adam_update_matches_reference(moment_dtype):
    """Three updates fed the same numpy gradients in both packages, the
    clip active on the first."""
    params, grads = _adam_case(7)
    jcfg = jadam.AdamConfig(moment_dtype=moment_dtype)
    cfg = adam.AdamConfig(moment_dtype=moment_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadam.init(jp, jcfg)
    tp = zoo.tree_map(lambda _, a: torch.from_numpy(a.copy()), params)
    ts = adam.init(tp, cfg)
    for g in grads:
        jp, js, jm = jadam.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  js, jp, jcfg)
        tp, ts, tm = adam.update(
            zoo.tree_map(lambda _, a: torch.from_numpy(a), g), ts, tp, cfg)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    want_p = dict(zoo.flatten(_np_tree(jp)))
    for name, t in zoo.flatten(tp):
        np.testing.assert_allclose(t.numpy(), want_p[name], rtol=1e-6,
                                   atol=1e-7)
    for mom in ("m", "v"):
        want = dict(zoo.flatten(_np_tree(js[mom])))
        for name, t in zoo.flatten(ts[mom]):
            assert t.dtype == getattr(torch, moment_dtype)
            got, w = t.float().numpy(), want[name].astype(np.float32)
            if moment_dtype == "float32":
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-12)
            else:   # one bf16 ulp: 2^-7 of the value's binade
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                          1e-38))) - 7)
                assert (np.abs(got - w) <= ulp).all(), name


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    """Three steps of ``build_train_step`` (default AdamConfig: bf16
    moments) on successive batches against the reference's step: losses
    within 1e-5 relative; parameters within 2e-2·lr of each other per step
    (bf16 moments may round the two packages' f32 moments a bf16 ulp apart)
    except where the reference gradient is float noise (module docstring)."""
    _check_train_steps("llama3.2-3b", accum)


@pytest.mark.parametrize("accum", [1, "own"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_train_steps_of_ssm_and_hybrid_match_reference(arch, accum):
    """The same three steps for the SSM and the reduced hybrid, whose
    empty tail the loss never reads: its leaves take their empty
    gradients, as ``jax.grad`` gives, so AdamW runs over every leaf.  With
    ``grad_accum`` 1 and the config's own (mamba2's 2, zamba2's 4)."""
    if accum == "own":
        accum = reduced_for_smoke(get_config(arch)).grad_accum
        assert accum > 1, arch
    _check_train_steps(arch, accum)


def test_train_steps_of_encdec_match_reference():
    """The same three steps for reduced whisper-medium, frames in every
    batch: the encoder's leaves take their gradients through every
    decoder layer's cross-attention."""
    _check_train_steps("whisper-medium", 1)


def _check_train_steps(arch, accum):
    jm, tree, model, params = _pair(arch, grad_accum=accum)
    opt_cfg, jopt_cfg = adam.AdamConfig(), jadam.AdamConfig()
    jstep = jax.jit(jsteps.build_train_step(jm, jopt_cfg))
    jgrad = jax.jit(jax.grad(lambda p, b: jm.forward(p, b)[0]))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jadam.init(jp, jopt_cfg)
    step = steps.build_train_step(model, opt_cfg)
    ts = adam.init(params, opt_cfg)
    noise = {name: np.zeros(a.shape, bool)
             for name, a in zoo.flatten(tree)}
    for i in range(3):
        batch = _batch(model.cfg.vocab, b=4, s=32, seed=10 + i,
                       cfg=model.cfg)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        for name, g in zoo.flatten(_np_tree(jgrad(jp, jb))):
            if g.size:
                noise[name] |= (g != 0) & (np.abs(g) < 1e-5 * np.abs(g).max())
        jp, js, jmet = jstep(jp, js, jb)
        params, ts, met = step(params, ts, _torch(batch))
        assert set(met) == {"loss", "grad_norm"}
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"])), i
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
            1e-4 * float(jmet["grad_norm"]), i
    assert int(ts["step"]) == 3
    want = dict(zoo.flatten(_np_tree(jp)))
    lim = 3 * 2e-2 * opt_cfg.lr
    for name, t in zoo.flatten(params):
        if t.numel() == 0:                   # the hybrid's empty tail
            continue
        keep = ~noise[name]
        assert keep.mean() > 0.99, name
        diff = np.abs(t.detach().numpy() - want[name])[keep]
        assert diff.max() <= lim, (name, float(diff.max()))


def test_input_specs_train_kind_matches_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES
    for arch in ("llama3.2-3b", "qwen2-0.5b"):
        got = zoo.input_specs(get_config(arch), SHAPES["train_4k"])
        want = jzoo.input_specs(jget_config(arch), JSHAPES["train_4k"])
        assert got["kind"] == want["kind"] == "train"
        assert set(got["batch"]) == set(want["batch"]) == {"tokens",
                                                            "labels"}
        for k, v in want["batch"].items():
            assert tuple(got["batch"][k].shape) == v.shape == (256, 4096)
            assert got["batch"][k].dtype == torch.int32
            assert got["batch"][k].device.type == "meta"


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-medium"])
def test_launcher_batch_carries_the_stub_frontends(arch, monkeypatch):
    """Both launchers, two steps of the reduced config: the port's step
    receives the reference's batch keys, shapes and dtypes every step —
    tokens and labels, and zero float32 ``patch_embs`` (B, n_patches,
    d_model) for a VLM or ``frames`` (B, enc_len, d_model) for an enc-dec
    model, as the reference's launcher adds them — and those stand-ins
    are zeros.  The port's batch is laid out on the launcher's mesh
    (``ShardedTensor`` inputs), read back whole."""
    from repro.launch import steps as jsteps_mod
    from repro.launch import train as jtrain
    from repro_torch.core import fm
    from repro_torch.launch import train
    seen = {"ref": [], "port": []}

    def record(mod, key, describe):
        real = mod.build_train_step

        def build(*a, **k):
            step = real(*a, **k)

            def recorded(params, opt_state, batch):
                seen[key].append({n: describe(v) for n, v in batch.items()})
                return step(params, opt_state, batch)
            return recorded
        monkeypatch.setattr(mod, "build_train_step", build)
    record(jsteps_mod, "ref", lambda v: (tuple(v.shape), str(v.dtype)))
    record(steps, "port", lambda v: (tuple(v.shape),
                                     str(v.dtype).replace("torch.", ""),
                                     v.full()))
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "100"]
    jtrain.main(argv)
    with fm.conf(device="cpu"):
        losses = train.main(argv)
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = reduced_for_smoke(get_config(arch))
    stub, shape = (("patch_embs", (2, cfg.n_patches, cfg.d_model))
                   if cfg.family == "vlm" else
                   ("frames", (2, cfg.enc_len, cfg.d_model)))
    assert len(seen["port"]) == 2 and seen["ref"]
    for got in seen["port"]:
        assert set(got) == set(seen["ref"][0]) == {"tokens", "labels", stub}
        for name, (shp, dt) in seen["ref"][0].items():
            assert got[name][:2] == (shp, dt), name
        assert got[stub][:2] == (shape, "float32")
        assert not got[stub][2].any()


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-medium",
                                  "mamba2-1.3b"])
def test_launcher_resume_keeps_the_batch(arch, tmp_path, monkeypatch):
    """The port's launcher checkpoints after two steps and resumes for two
    more: the resumed steps receive the same batch keys, shapes and dtypes
    as the first run's — the stub frontend of a VLM or an enc-dec model
    too, and nothing of the checkpoint's metadata — and train to finite
    losses, with grad_accum > 1 (mamba2-1.3b) as with 1."""
    from repro_torch.core import fm
    from repro_torch.launch import train
    seen = []
    real = steps.build_train_step

    def build(*a, **k):
        step = real(*a, **k)

        def recorded(params, opt_state, batch):
            seen.append({n: (tuple(v.shape), v.dtype)
                         if isinstance(v, torch.Tensor) else type(v).__name__
                         for n, v in batch.items()})
            return step(params, opt_state, batch)
        return recorded
    monkeypatch.setattr(steps, "build_train_step", build)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
            "--log-every", "100"]
    with fm.conf(device="cpu"):
        first = train.main(argv + ["--steps", "2"])
        resumed = train.main(argv + ["--steps", "4", "--resume"])
    assert len(first) == len(resumed) == 2
    assert all(np.isfinite(first + resumed))
    assert len(seen) == 4
    assert all(got == seen[0] for got in seen[1:]), seen


def test_opt_state_from_numpy_carries_the_reference_state():
    jm, tree, model, params = _pair("qwen2-0.5b")
    js = _np_tree(jadam.init(jax.tree_util.tree_map(jnp.asarray, tree)))
    js["step"] = np.asarray(5, np.int32)
    rng = np.random.default_rng(1)
    js["m"] = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(ml_dtypes.bfloat16),
        js["m"])
    st = zoo.opt_state_from_numpy(model.cfg, js, "cpu")
    assert int(st["step"]) == 5 and st["step"].dtype == torch.int32
    for name, t in zoo.flatten(st["m"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy(),
            dict(zoo.flatten(js["m"]))[name].astype(np.float32))


@pytest.mark.parametrize("accum", [1, 2])
def test_a_leaf_the_loss_never_reaches_raises(accum):
    """Only a zero-length leaf may go without a gradient: a non-empty leaf
    the loss never reads fails the step rather than train on zeros."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              grad_accum=accum)
    model = zoo.build(cfg, device="cpu")
    params = dict(model.init(0), stray=torch.zeros(3))
    with pytest.raises(RuntimeError, match="stray"):
        steps.loss_and_grads(model, params,
                             _torch(_batch(cfg.vocab, b=2, s=16)))


def test_other_families_still_raise_with_a14():
    """``transformer.forward`` refuses the SSM, hybrid and enc-dec families,
    naming ``zoo.module_for``.  The launcher's ``--model-parallel`` > 1
    raised naming A14 until the sharded train step came (A14a); now it
    builds ``make_host_mesh(model=2)``, which one CPU cannot make, and
    raises that mesh's ``ValueError`` as the reference's launcher fails on
    one device."""
    from repro_torch.models import transformer
    for family in ("ssm", "hybrid", "encdec"):
        cfg = dataclasses.replace(
            reduced_for_smoke(get_config("llama3.2-3b")), family=family)
        with pytest.raises(ValueError, match="module_for"):
            transformer.forward(cfg, {}, {})
    from repro_torch.launch import train
    from repro_torch.core import fm
    with fm.conf(device="cpu"), pytest.raises(ValueError, match="model=2"):
        train.main(["--arch", "qwen2-0.5b", "--reduced",
                    "--model-parallel", "2"])


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_leaf_gradients_equal_select_and_refuse_autograd_grad(
        remat, monkeypatch):
    """The train forward's per-layer slices give each stacked leaf the
    gradient that plain ``stacked[i]`` views give, in ``.grad``; a backward
    that would not accumulate into the leaves raises."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              remat=remat)
    model = zoo.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch(_batch(cfg.vocab))
    flat = list(zoo.flatten(params))
    for _, p in flat:
        p.requires_grad_(True)
    model.forward(params, batch)[0].backward()
    got = {k: p.grad for k, p in flat}
    with pytest.raises(RuntimeError, match="stacked layer leaf"):
        torch.autograd.grad(model.forward(params, batch)[0],
                            [p for _, p in flat])
    for _, p in flat:
        p.grad = None
    monkeypatch.setattr(transformer, "train_layer", transformer.layer)
    model.forward(params, batch)[0].backward()
    for k, p in flat:
        assert torch.equal(got[k], p.grad), k


def test_training_modules_import_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from repro_torch import checkpoint, data, optim, runtime
        from repro_torch.checkpoint import checkpoint as ck
        from repro_torch.data import pipeline
        from repro_torch.launch import steps, train
        from repro_torch.models import (encdec, hybrid, layers, moe, ssm,
                                        ssm_lm, transformer, zoo)
        from repro_torch.optim import adam, schedule
        from repro_torch.runtime import fault_tolerance
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro.")
                     or m.startswith("jax"))
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("clean")
    """)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
