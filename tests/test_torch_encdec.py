"""The port's enc-dec family (repro_torch/models/encdec.py) on the CPU
against the JAX package's module, piece by piece.

Reduced whisper-medium (``reduced_for_smoke``: 2 encoder + 2 decoder
layers, d_model 128, 4 heads of 32, enc_len 32, vocab 512, float32), the
reference's parameters from ``model.init(PRNGKey(0))`` with their
layernorm scales and biases redrawn from a seeded numpy RNG, carried
across with ``params_from_numpy``; frames, hidden states and tokens from
the same RNG:

* ``encode`` (frames + sinusoids, bidirectional attention through
  ``ops.attention(causal=False)``) within 1e-5 of the largest |entry|;
* one ``_dec_block`` at prefill — causal self-attention at S == T and
  cross-attention over the encoder output at S != T, both through
  ``ops.attention`` — its output and both K/V pairs within 1e-5;
* ``ops.attention(causal=False)`` at S != T, GQA layout, against the
  Pallas kernel (interpret mode) on repeated KV and against the
  reference's cross-attention;
* the train forward through ``blockwise_attention`` (the threshold set
  low in both packages): every attention of encoder and decoder, the
  cross-attention's T != S included, within the LM twins' 1e-5 / 1e-4.

On the CPU ``ops.attention`` runs the flash kernel's plain version; the
kernel itself is held to it at whisper's shapes on the card
(tests/test_torch_cuda.py, chip_smoke.py path o).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_for_smoke as jreduced
from repro.kernels import ops as jops
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro.models.base import tree_unbox
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import encdec, layers, transformer, zoo

ARCH = "whisper-medium"
B, S = 2, 20


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, its numpy params, port cfg, port params, rng)."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_for_smoke(get_config(ARCH))
    params, _ = tree_unbox(jzoo.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        if name.endswith("['bias']"):
            return (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return np.asarray(a)
    tree = jax.tree_util.tree_map_with_path(redraw, params)
    return jcfg, tree, cfg, zoo.params_from_numpy(cfg, tree, "cpu"), rng


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_encode_matches_reference(pair):
    jcfg, tree, cfg, params, rng = pair
    frames = rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    want = np.asarray(jencdec.encode(jcfg, _j(tree), jnp.asarray(frames)))
    before = fa.launches
    got = encdec.encode(cfg, params, torch.from_numpy(frames))
    assert got.shape == (B, cfg.enc_len, cfg.d_model)
    assert _rel(got.numpy(), want) < 1e-5
    assert fa.launches == before          # the plain version on the CPU


def test_dec_block_at_prefill_matches_reference(pair, monkeypatch):
    """Layer 0 of the decoder over hidden states x (B, S, d) and an encoder
    output (B, enc_len, d): the block's output, its self K/V (B, S, nkv,
    hd) and its cross K/V (B, enc_len, nkv, hd)."""
    jcfg, tree, cfg, params, rng = pair
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    epos = np.broadcast_to(np.arange(cfg.enc_len, dtype=np.int32),
                           (B, cfg.enc_len)).copy()
    jblk = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                  tree["dec_layers"])
    jx, jkv, jcross = jencdec._dec_block(jcfg, jblk, jnp.asarray(x),
                                         jnp.asarray(pos), jnp.asarray(enc),
                                         jnp.asarray(epos))
    calls = []
    real = ops.attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "attention", spy)
    gx, gkv, gcross = encdec._dec_block(
        cfg, transformer.layer(params["dec_layers"], 0), torch.from_numpy(x),
        torch.from_numpy(pos), torch.from_numpy(enc), torch.from_numpy(epos),
        encdec._serve_attention("auto"))
    assert calls == [(S, S, True), (S, cfg.enc_len, False)]
    assert _rel(gx.numpy(), jx) < 1e-5
    for got, want in zip(gkv + gcross, jkv + jcross):
        assert tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("S_,T_", [(20, 32), (45, 13)])
def test_cross_attention_through_ops_matches_reference(pair, S_, T_):
    """Non-causal S != T: ``ops.attention`` on (B, nh, S, hd) over (B,
    nkv, T, hd) against the Pallas kernel (interpret mode) on KV repeated
    to every head, and the port's cross-attention against the reference's
    ``apply_attention(xkv=)``."""
    jcfg, tree, cfg, params, rng = pair
    nh, nkv, hd = 4, 2, 32
    q = rng.normal(size=(B, nh, S_, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, nkv, T_, hd)).astype(np.float32)
            for _ in range(2))
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=False)
    rep = [np.repeat(a, nh // nkv, axis=1).reshape(B * nh, T_, hd)
           for a in (k, v)]
    want = jops.flash_attention(jnp.asarray(q.reshape(-1, S_, hd)),
                                *(jnp.asarray(a) for a in rep), causal=False,
                                bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(q.shape),
                               rtol=2e-3, atol=2e-3)
    x = rng.normal(size=(B, S_, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, T_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B, S_)).copy()
    epos = np.broadcast_to(np.arange(T_, dtype=np.int32), (B, T_)).copy()
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["dec_layers"]["cross"])
    jout, (jk, jv) = jlayers.apply_attention(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos), causal=False,
        use_rope=False, xkv=jnp.asarray(enc), kv_positions=jnp.asarray(epos))
    out, (tk, tv) = layers.apply_attention(
        cfg, transformer.layer(params["dec_layers"]["cross"], 0),
        torch.from_numpy(x), torch.from_numpy(pos), causal=False,
        use_rope=False, xkv=torch.from_numpy(enc),
        kv_positions=torch.from_numpy(epos))
    assert _rel(out.numpy(), jout) < 1e-5
    assert _rel(tk.numpy(), jk) < 1e-5 and _rel(tv.numpy(), jv) < 1e-5
    with pytest.raises(ValueError, match="by index"):
        layers.apply_attention(
            cfg, transformer.layer(params["dec_layers"]["cross"], 0),
            torch.from_numpy(x), torch.from_numpy(pos), causal=True,
            use_rope=False, xkv=torch.from_numpy(enc))


def test_train_forward_through_blockwise_matches_reference(pair,
                                                           monkeypatch):
    """``_BLOCKWISE_THRESHOLD`` 8 in both packages: every attention of the
    train forward (encoder 32 × 32, decoder self 20 × 20, cross 20 × 32,
    not causal) takes ``blockwise_attention``, as train_4k's 4096 × 1500
    cross-attention does at full size; the loss within 1e-5 and every
    gradient within 1e-4 of the reference's."""
    jcfg, tree, cfg, params, rng = pair
    monkeypatch.setattr(jlayers, "_BLOCKWISE_THRESHOLD", 8)
    monkeypatch.setattr(layers, "_BLOCKWISE_THRESHOLD", 8)
    taken = []
    real = layers.blockwise_attention
    monkeypatch.setattr(layers, "blockwise_attention", lambda *a, **k:
                        taken.append((a[0].shape[1], a[1].shape[1], a[5]))
                        or real(*a, **k))
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "frames": rng.normal(size=(B, cfg.enc_len, cfg.d_model))
             .astype(np.float32)}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jencdec.forward(jcfg, p, _j(batch)), has_aux=True)(_j(tree))
    p = zoo.tree_map(lambda _, t: t.clone().requires_grad_(True), params)
    loss, _ = encdec.forward(cfg, p, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    loss.backward()
    E = cfg.enc_len
    assert taken == ([(E, E, False)] * cfg.n_enc_layers
                     + [(S, S, True), (S, E, False)] * cfg.n_layers)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    want = dict(zoo.flatten(jax.tree_util.tree_map(np.asarray, jg)))
    for name, t in zoo.flatten(p):
        assert _rel(t.grad.numpy(), want[name]) < 1e-4, name


def test_prefill_and_decode_below_enc_len_match_reference(pair):
    """C7: a prefill of 20 frames where the config's enc_len is 32 — the
    reference sizes its cross K/V by the encoder's output and serves it —
    then two decode steps: (B, 5) tokens, max_len 16, the logits of every
    step and every cache leaf within 1e-4 of the largest |entry|."""
    jcfg, tree, cfg, params, rng = pair
    F_, S_, max_len = 20, 5, 16
    frames = rng.normal(size=(B, F_, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S_ + 2)).astype(np.int32)
    jm, m = jzoo.build(jcfg), zoo.build(cfg, "cpu")
    jp = _j(tree)
    jcache, jlog = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                   "tokens": jnp.asarray(toks[:, :S_])},
                              max_len)
    cache, log = m.prefill(params, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(toks[:, :S_])},
                           max_len)
    assert tuple(cache["cross_k"].shape) == jcache["cross_k"].shape == \
        (cfg.n_layers, B, F_, cfg.n_kv_heads, cfg.hd)
    steps_ = [(log, jlog)]
    for t in range(S_, S_ + 2):
        jcache, jl = jm.decode(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        cache, lg = m.decode(params, cache, torch.from_numpy(toks[:, t:t + 1]))
        steps_.append((lg, jl))
    for got, want in steps_:
        assert _rel(got.numpy(), want) < 1e-4
    want = dict(zoo.flatten(jax.tree_util.tree_map(np.asarray, jcache)))
    for name, t in zoo.flatten(cache):
        if t.ndim == 0:
            assert int(t) == int(want[name]) == S_ + 2
        else:
            assert tuple(t.shape) == want[name].shape, name
            assert _rel(t.numpy(), want[name]) < 1e-4, name
