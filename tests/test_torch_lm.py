"""The port's LM serving path on the CPU against the JAX package.

Reduced llama3.2-3b and qwen2-0.5b (dense), qwen3-moe-30b-a3b and
arctic-480b (MoE: 8 experts, top-2, arctic with its dense residual) and
paligemma-3b (VLM: MQA, tied embeddings, GeGLU, 8 patch embeddings before
the text), mamba2-1.3b (SSM: 8 heads of 32, state 16) and zamba2-7b
(hybrid: the shared attention block every 2 SSM layers; at 2 layers no
tail, and at 5 layers — ``zamba2-7b:5`` in both packages — two groups and
a tail of 1) and whisper-medium (enc-dec: 2 encoder and 2 decoder layers,
layernorm, sinusoidal positions, 32 frames; the cache's cross K/V too) —
``reduced_for_smoke``: 2 layers, d_model 128, 4 heads over 2 KV heads (1
for paligemma, 4 for whisper), head dim 32, vocab 512, float32: the
reference's parameters from ``model.init(PRNGKey(0))``, their norm scales
and biases, QKV biases and the SSM's constant leaves (``A_log``,
``dt_bias``, ``conv_b``, ``D``, the gated norm) redrawn from a seeded numpy
RNG so that those leaves matter, carried across with
``params_from_numpy``; the patch embeddings and frames drawn from the same
RNG.  The MoE prompts are dropless (S·k <=
4096), as the reference's serving check is.  Prefill logits and every
cache leaf (KV, SSM state, conv window, the hybrid's per-application KV)
agree with ``repro.models.zoo.build(cfg).prefill`` within 1e-4 of their
largest value, one decode step with ``decode`` likewise, and prefill +
decode with a prefill one token longer within 2e-2 (the twin of
tests/test_archs.py's serving check).  Attention runs the flash kernel's
plain version here; the kernel itself is held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced_for_smoke as jreduced
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro.models.base import tree_unbox
from repro_torch.configs import (ARCH_IDS, PORTED_IDS, SHAPES, get_config,
                                 reduced_for_smoke)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps
from repro_torch.models import hybrid, layers, zoo

ARCHS = ["llama3.2-3b", "qwen2-0.5b", "qwen3-moe-30b-a3b", "arctic-480b",
         "paligemma-3b", "mamba2-1.3b", "zamba2-7b", "zamba2-7b:5",
         "whisper-medium"]
#: Names of the SSM leaves that init to constants (zeros or ones).
SSM_CONST = ("['A_log']", "['dt_bias']", "['conv_b']", "['D']", "['norm']")
B, S = 2, 33


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One reduced arch through both packages: the JAX prefill of S and
    S + 1 tokens and one decode step, the port's parameters."""
    arch, _, layers_ = request.param.partition(":")
    jcfg, cfg = jreduced(jget_config(arch)), reduced_for_smoke(get_config(arch))
    if layers_:
        jcfg = dataclasses.replace(jcfg, n_layers=int(layers_))
        cfg = dataclasses.replace(cfg, n_layers=int(layers_))
    jm = jzoo.build(jcfg)
    params, _ = tree_unbox(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    tree = jax.tree_util.tree_map(np.asarray, params)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith(SSM_CONST):
            return (1.0 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype) \
                if name.endswith(("['D']", "['norm']")) else \
                (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if "scale" in name or "'b" in name:          # ones / zeros at init
            return (1.0 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype) \
                if "scale" in name else \
                (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    patches = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
               .astype(np.float32) if cfg.family == "vlm" else None)
    frames = (rng.normal(size=(B, cfg.enc_len, cfg.d_model))
              .astype(np.float32) if cfg.family == "encdec" else None)
    max_len = cfg.n_patches + S + 8
    extra = {} if patches is None else {"patch_embs": jnp.asarray(patches)}
    if frames is not None:
        extra["frames"] = jnp.asarray(frames)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t, **extra},
                                               max_len))
    jcache, jlogits = prefill(jparams, jnp.asarray(toks[:, :S]))
    _, jfull = prefill(jparams, jnp.asarray(toks))
    jcache2, jdec = jax.jit(jm.decode)(jparams, jcache,
                                       jnp.asarray(toks[:, S:]))
    model = zoo.build(cfg, device="cpu")
    return dict(arch=arch, cfg=cfg, model=model, toks=toks, patches=patches,
                frames=frames, max_len=max_len,
                params=zoo.params_from_numpy(cfg, tree, "cpu"),
                jcache=jax.tree_util.tree_map(np.asarray, jcache),
                jlogits=np.asarray(jlogits), jfull=np.asarray(jfull),
                jcache2=jax.tree_util.tree_map(np.asarray, jcache2),
                jdec=np.asarray(jdec))


def _batch(case, toks):
    batch = {"tokens": torch.from_numpy(toks)}
    if case["patches"] is not None:
        batch["patch_embs"] = torch.from_numpy(case["patches"])
    if case["frames"] is not None:
        batch["frames"] = torch.from_numpy(case["frames"])
    return batch


def _prefill(case, toks):
    step = steps.build_prefill_step(case["model"], case["max_len"])
    return step(case["params"], _batch(case, toks))


def _check_cache(cache, want):
    """Every leaf but ``len`` of the port's cache against the reference's:
    the same keys and shapes, values within 1e-4 of the largest (a
    zero-length leaf, the hybrid's empty tail, only by shape)."""
    got = {k: v.numpy() for k, v in zoo.flatten(cache) if k != "len"}
    want = {k: np.asarray(v) for k, v in zoo.flatten(want) if k != "len"}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.size:
            assert _rel(got[k], v) < 1e-4, k


def _kv_lead(cfg):
    """Leading length of the KV cache: a layer each, or for the hybrid an
    application of the shared block each."""
    if cfg.family == "hybrid":
        return hybrid.group_shape(cfg)[0]
    return cfg.n_layers


def test_prefill_logits_and_cache_match_reference(case):
    cache, logits = _prefill(case, case["toks"][:, :S])
    assert logits.shape == (B, 1, case["cfg"].vocab)
    assert _rel(logits.numpy(), case["jlogits"]) < 1e-4
    cfg = case["cfg"]
    if cfg.family != "ssm":
        for kv in ("k", "v"):
            assert cache["kv"][kv].shape == (_kv_lead(cfg), B,
                                             case["max_len"],
                                             cfg.n_kv_heads, cfg.hd)
    _check_cache(cache, case["jcache"])
    n = case["cfg"].n_patches + S
    assert int(cache["len"]) == int(case["jcache"]["len"]) == n


def test_decode_step_matches_reference(case):
    cache, _ = _prefill(case, case["toks"][:, :S])
    decode = steps.build_decode_step(case["model"])
    cache, logits = decode(case["params"], cache,
                           torch.from_numpy(case["toks"][:, S:]))
    assert _rel(logits.numpy(), case["jdec"]) < 1e-4
    _check_cache(cache, case["jcache2"])
    n = case["cfg"].n_patches + S + 1
    assert int(cache["len"]) == int(case["jcache2"]["len"]) == n


def test_prefill_decode_matches_longer_prefill(case):
    """Prefill S then decode the token at S against prefill of S + 1 (the
    port's twin of tests/test_archs.py::test_prefill_decode_matches_forward),
    and the reference's own prefill of S + 1."""
    cache, _ = _prefill(case, case["toks"][:, :S])
    _, dec = steps.build_decode_step(case["model"])(
        case["params"], cache, torch.from_numpy(case["toks"][:, S:]))
    _, full = _prefill(case, case["toks"])
    assert _rel(dec.numpy(), full.numpy()) < 2e-2
    assert _rel(full.numpy(), case["jfull"]) < 1e-4


def test_prefill_with_ref_attention_matches_auto(case):
    """impl='ref' (the plain version, explicitly) gives the path's result;
    on the CPU 'auto' takes that plain version too, and counts no launch."""
    before = fa.launches
    _, a = _prefill(case, case["toks"][:, :S])
    step = steps.build_prefill_step(case["model"], case["max_len"],
                                    attn_impl="ref")
    _, r = step(case["params"], _batch(case, case["toks"][:, :S]))
    assert torch.equal(a, r) and fa.launches == before


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_reference(theta):
    """Half-split RoPE with the reference's f32 frequencies, out to the
    positions of a 32k prefill.  The formula is the reference's; XLA's f32
    exp and PyTorch's differ by one ulp on some frequencies, which moves an
    angle by up to pos · 2⁻²³ radians (2e-3 at 32767), so the limit grows
    with the position."""
    import math
    half = 64
    ar = np.arange(half, dtype=np.float32)
    f_t = torch.exp(-math.log(theta) * torch.from_numpy(ar) / half).numpy()
    f_j = np.asarray(jnp.exp(-math.log(theta) * jnp.asarray(ar) / half))
    assert np.abs(f_t.view(np.int32) - f_j.view(np.int32)).max() <= 1
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 2 * half)).astype(np.float32)
    pos = np.array([[0, 1, 4095, 4096, 32767], [7, 100, 2047, 20000, 30000]],
                   np.int32)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    err = np.abs(got.numpy() - want).max(axis=(2, 3))
    assert (err <= (1e-5 + pos * 2.0 ** -22) * np.abs(x).max()).all()


@pytest.mark.parametrize("d", [128, 1024])
def test_sinusoidal_matches_reference(d):
    """The enc-dec family's sin/cos encodings, in f32, out to whisper's
    last frame (1499) and past its text context.  The formula is the
    reference's; as in the RoPE twin, a one-ulp difference of the f32
    frequencies moves an angle by up to pos · 2⁻²³ radians, so the limit
    grows with the position."""
    pos = np.array([[0, 1, 2, 447, 448], [100, 1023, 1024, 1498, 1499]],
                   np.int32)
    got = layers.sinusoidal(torch.from_numpy(pos), d).numpy()
    want = np.asarray(jlayers.sinusoidal(jnp.asarray(pos), d))
    assert got.shape == want.shape == (2, 5, d) and got.dtype == np.float32
    err = np.abs(got - want).max(axis=-1)
    assert (err <= 1e-5 + pos * 2.0 ** -22).all()


@pytest.mark.parametrize("norm,act", [("rmsnorm", "swiglu"),
                                      ("layernorm", "geglu"),
                                      ("rmsnorm", "gelu")])
def test_norm_and_mlp_match_reference(norm, act):
    import dataclasses
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              norm=norm, act=act)
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-3b")),
                               norm=norm, act=act)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    pn = {"scale": rng.normal(size=cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        pn["bias"] = rng.normal(size=cfg.d_model).astype(np.float32)
    pm = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in (
        ("wi", (cfg.d_model, cfg.d_ff)), ("wg", (cfg.d_model, cfg.d_ff)),
        ("wo", (cfg.d_ff, cfg.d_model)))}
    t = {k: torch.from_numpy(v) for k, v in pn.items()}
    j = {k: jnp.asarray(v) for k, v in pn.items()}
    np.testing.assert_allclose(
        layers.apply_norm(cfg, t, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.apply_norm(jcfg, j, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in pm.items()},
                         torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.apply_mlp(jcfg, {k: jnp.asarray(v)
                                            for k, v in pm.items()},
                                     jnp.asarray(x))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_parameter_tree_matches_reference_at_full_width(arch):
    """The port's tree from its family's own ``init`` (meta device: nothing
    allocated) has the reference's keys and shapes at the published
    widths, and its count is the config's ``n_params`` plus what that
    leaves out: the norm scales (two a layer and the final one; the SSM's
    one a layer, the hybrid's one an SSM layer and the shared block's two;
    the enc-dec's two an encoder layer, three a decoder layer and two
    final ones, each layernorm with its bias), QKV biases and the SSM's
    conv biases."""
    cfg = get_config(arch)
    jshapes, _ = jzoo.build(jget_config(arch)).abstract_params()
    want = dict(zoo.flatten(jax.tree_util.tree_map(lambda s: s.shape,
                                                    jshapes)))
    tree = zoo.module_for(cfg).init(cfg, None)
    got = {k: tuple(v.shape) for k, v in zoo.flatten(tree)}
    assert got == {k: tuple(v) for k, v in want.items()}
    count = sum(int(np.prod(s)) for s in got.values())
    n_norms = {"ssm": cfg.n_layers + 1, "hybrid": cfg.n_layers + 3,
               "encdec": 2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2}.get(
                   cfg.family, 2 * cfg.n_layers + 1)
    norms = n_norms * cfg.d_model * (2 if cfg.norm == "layernorm" else 1)
    biases = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        if cfg.qkv_bias else 0
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        biases += cfg.n_layers * (d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state)
    assert count - norms - biases == cfg.n_params()


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2),
                                           ("zamba2-7b", 2), ("zamba2-7b", 5)])
def test_params_from_numpy_round_trips_ssm_and_hybrid_trees(arch, n_layers):
    """The reference's ``ssm_lm`` and ``hybrid`` trees carried across and
    back to numpy unchanged, the hybrid's group leaves (n_groups, every,
    …) and its tail (tail, …), zero-length at 2 layers, included."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), n_layers=n_layers)
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              n_layers=n_layers)
    params, _ = tree_unbox(jzoo.build(jcfg).init(jax.random.PRNGKey(1)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = zoo.params_from_numpy(cfg, tree, "cpu")
    want = dict(zoo.flatten(tree))
    assert set(dict(zoo.flatten(got))) == set(want)
    for name, t in zoo.flatten(got):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), want[name])
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        tail = n_layers % every
        assert got["groups"]["ln"]["scale"].shape == (
            n_layers // every, every, cfg.d_model)
        assert got["tail"]["ssm"]["in_proj"].shape[0] == tail
    tree["layers" if cfg.family == "ssm" else "tail"]["ln"]["scale"] = \
        np.ones((n_layers + 1, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="shape"):
        zoo.params_from_numpy(cfg, tree, "cpu")


def test_init_law_and_serving_dtype():
    """Each weight is N(0, fan_in^-1): fan_in = shape[0] of one layer's
    matrix, the last dim for the embedding; norm scales are ones.  Serving
    parameters are all bf16, norm scales included."""
    cfg = reduced_for_smoke(get_config("llama3.2-3b"))
    gen = torch.Generator().manual_seed(0)
    p = zoo.build(cfg, device="cpu").init(gen)
    wi = p["layers"]["mlp"]["wi"]
    assert wi.shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    tok = p["embed"]["tok"]
    assert abs(float(tok.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    sp = steps.serving_model(cfg, device="cpu").init(2016)
    assert {t.dtype for _, t in zoo.flatten(sp)} == {torch.bfloat16}
    again = steps.serving_model(cfg, device="cpu").init(2016)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(zoo.flatten(sp), zoo.flatten(again)))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "paligemma-3b",
                                  "whisper-medium"])
def test_input_specs_match_reference(arch):
    """Shapes and dtypes of every cell's inputs; the VLM's tokens are the
    text after its 256 patches, its patch embeddings in ``cfg.dtype``; the
    enc-dec's 1500 frames in ``cfg.dtype`` beside its tokens."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = zoo.input_specs(cfg, SHAPES[name])
        want = jzoo.input_specs(jcfg, JSHAPES[name])
        assert got["kind"] == want["kind"]
        assert got.get("max_len") == want.get("max_len")
        assert set(got["batch"]) == set(want["batch"])
        for k, v in want["batch"].items():
            assert tuple(got["batch"][k].shape) == v.shape
            assert str(got["batch"][k].dtype) == f"torch.{v.dtype}"
            assert got["batch"][k].device.type == "meta"


def test_unported_families_and_bad_inputs_raise():
    """Every architecture of the reference is ported; an unknown family, a
    prompt shorter than the SSM's conv window and a prompt past max_len
    raise.  An enc-dec prefill of another frame count than ``enc_len``
    raised too until C7 was closed: it now sizes the cross K/V by the
    frames, as the reference does (test_torch_encdec.py holds it to the
    reference)."""
    assert set(ARCH_IDS) == set(PORTED_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).family in zoo.FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        zoo.build(dataclasses.replace(get_config("llama3.2-3b"),
                                      family="diffusion"), device="cpu")
    cfg = reduced_for_smoke(get_config("qwen2-0.5b"))
    model = zoo.build(cfg, device="cpu")
    tree = model.init(0)
    tree["final_norm"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        zoo.params_from_numpy(cfg, tree, "cpu")
    with pytest.raises(ValueError, match="keys"):
        zoo.params_from_numpy(cfg, {"embed": {}}, "cpu")
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(model.init(0),
                      {"tokens": torch.zeros(1, 9, dtype=torch.int64)}, 8)
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        model = zoo.build(reduced_for_smoke(get_config(arch)), device="cpu")
        with pytest.raises(ValueError, match="conv window"):
            model.prefill(model.init(0),
                          {"tokens": torch.zeros(1, 2, dtype=torch.int32)}, 8)
    cfg = reduced_for_smoke(get_config("whisper-medium"))
    model = zoo.build(cfg, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    frames = torch.zeros(1, cfg.enc_len, cfg.d_model)
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(model.init(0), {"tokens": toks, "frames": frames}, 3)
    cache, _ = model.prefill(model.init(0), {"tokens": toks, "frames":
                             torch.zeros(1, cfg.enc_len + 1, cfg.d_model)}, 8)
    assert cache["cross_k"].shape[2] == cfg.enc_len + 1


def test_building_without_asking_for_the_cpu_raises_without_a_card():
    """zoo.build with no device takes the engine's knob, cuda by default;
    with no card it raises rather than run on the CPU unasked.  Run in a
    fresh process so no test's fm.conf(device='cpu') is in effect."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    code = ("from repro_torch.configs import get_config, reduced_for_smoke\n"
            "from repro_torch.models import zoo\n"
            "cfg = reduced_for_smoke(get_config('llama3.2-3b'))\n"
            "for dev in (None, 'cuda'):\n"
            "    try:\n"
            "        zoo.build(cfg, device=dev)\n"
            "    except RuntimeError as e:\n"
            "        assert 'is_available' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit(f'built on {dev} without a card')\n"
            "from repro_torch.core import fm\n"
            "fm.set_conf(device='cpu')\n"
            "assert zoo.build(cfg).device.type == 'cpu'\n"
            "print('raised')\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
