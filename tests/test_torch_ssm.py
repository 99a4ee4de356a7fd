"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU.

Inputs are drawn with numpy from a seed and run through both packages'
functions in float32 at mamba2-1.3b's reduced width (d_model 128, 8 heads
of 32, state 16, conv width 4), with one and two B/C groups; the port is
held to 1e-5 of the largest value unless a case says otherwise:
``_conv_full``, ``_gated_norm``, ``ssd_chunked`` (one and two chunks, with
and without an initial state, the final state too; three chunks run one
and two at a time), ``apply_ssm`` at
S = 128 and at the ragged 33 and 200 (the pad path), and one
``apply_ssm_decode`` step, cache included.  ``ssd_chunked`` is also held
to a float64 token-by-token recurrence written here, an oracle
independent of both packages.  The overflow case: dt = 0.7 over a full
128-token chunk, where the reference's unmasked decay exponent passes
float32's range — the port's forward equals the reference's and is
finite, the port's gradient is finite, and the reference's gradient is
NaN (asserted, so that a change on either side shows).  Last, the tree
and init law of ``init_ssm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_for_smoke as jreduced
from repro.models import ssm as jssm
from repro.models.base import keygen, tree_unbox
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.models import ssm

TOL = 1e-5


def _cfgs(groups=1):
    """(port cfg, reference cfg): reduced mamba2-1.3b in float32."""
    cfg = reduced_for_smoke(get_config("mamba2-1.3b"))
    jcfg = jreduced(jget_config("mamba2-1.3b"))
    return (dataclasses.replace(cfg, ssm_ngroups=groups),
            dataclasses.replace(jcfg, ssm_ngroups=groups))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _layer(cfg, rng):
    """One SSM layer's parameters as numpy, every leaf drawn (the constant
    ones — zeros and ones at init — perturbed so that they matter)."""
    d_in, H, P, N, G = ssm.dims(cfg)
    d, C = cfg.d_model, d_in + 2 * G * N
    f = np.float32
    return {
        "in_proj": (rng.normal(size=(d, 2 * d_in + 2 * G * N + H))
                    * d ** -0.5).astype(f),
        "conv_w": (rng.normal(size=(cfg.ssm_conv, C)) * 0.5).astype(f),
        "conv_b": (0.1 * rng.normal(size=C)).astype(f),
        "A_log": (0.3 * rng.normal(size=H)).astype(f),
        "dt_bias": (0.3 * rng.normal(size=H)).astype(f),
        "D": (1 + 0.2 * rng.normal(size=H)).astype(f),
        "norm": (1 + 0.2 * rng.normal(size=d_in)).astype(f),
        "out_proj": (rng.normal(size=(d_in, d)) * d_in ** -0.5).astype(f),
    }


def _ssd_inputs(rng, B, S, H, P, G, N, dt=None):
    f = np.float32
    return dict(
        xh=rng.normal(size=(B, S, H, P)).astype(f),
        dt=(np.full((B, S, H), dt, f) if dt is not None else
            rng.uniform(0.01, 0.5, size=(B, S, H)).astype(f)),
        a_log=(0.3 * rng.normal(size=H)).astype(f),
        Bc=rng.normal(size=(B, S, G, N)).astype(f),
        Cc=rng.normal(size=(B, S, G, N)).astype(f))


@pytest.mark.parametrize("S", [33, 128, 200])
def test_conv_full_matches_reference(S):
    cfg, _ = _cfgs()
    rng = np.random.default_rng(S)
    C = 40
    x = rng.normal(size=(2, S, C)).astype(np.float32)
    w = rng.normal(size=(cfg.ssm_conv, C)).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    got = ssm._conv_full(_t(x), _t(w), _t(b)).numpy()
    want = np.asarray(jssm._conv_full(_j(x), _j(w), _j(b)))
    assert got.shape == want.shape == (2, S, C)
    assert _rel(got, want) < TOL


def test_gated_norm_matches_reference():
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(1)
    y, z = (rng.normal(size=(2, 9, 256)).astype(np.float32) for _ in range(2))
    w = (1 + 0.2 * rng.normal(size=256)).astype(np.float32)
    got = ssm._gated_norm(cfg, _t(w), _t(y), _t(z)).numpy()
    want = np.asarray(jssm._gated_norm(jcfg, _j(w), _j(y), _j(z)))
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(S, groups, with_state):
    rng = np.random.default_rng(S + groups + 10 * with_state)
    B, H, P, N = 2, 4, 8, 16
    inp = _ssd_inputs(rng, B, S, H, P, groups, N)
    s0 = (rng.normal(size=(B, H, P, N)).astype(np.float32)
          if with_state else None)
    y, st = ssm.ssd_chunked(**{k: _t(v) for k, v in inp.items()},
                            init_state=None if s0 is None else _t(s0))
    jy, jst = jssm.ssd_chunked(**{k: _j(v) for k, v in inp.items()},
                               init_state=None if s0 is None else _j(s0))
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    assert _rel(y.numpy(), jy) < TOL
    assert _rel(st.numpy(), jst) < TOL


@pytest.mark.parametrize("per_block", [1, 2])
def test_ssd_chunked_blocks_of_chunks_match_reference(per_block, monkeypatch):
    """Three chunks run 1 or 2 at a time (the last block ragged), as
    ``TILE_BYTES`` sets: the reference's output and final state, and the
    one-block run's within 1e-6."""
    rng = np.random.default_rng(30 + per_block)
    B, S, H, P, G, N = 2, 384, 4, 8, 2, 16
    inp = {k: _t(v) for k, v in _ssd_inputs(rng, B, S, H, P, G, N).items()}
    s0 = _t(rng.normal(size=(B, H, P, N)).astype(np.float32))
    whole = ssm.ssd_chunked(**inp, init_state=s0)
    monkeypatch.setattr(ssm, "TILE_BYTES", per_block * B * H * 128 * 128 * 4)
    y, st = ssm.ssd_chunked(**inp, init_state=s0)
    jy, jst = jssm.ssd_chunked(**{k: _j(v) for k, v in inp.items()},
                               init_state=_j(s0))
    assert _rel(y.numpy(), jy) < TOL and _rel(st.numpy(), jst) < TOL
    assert _rel(y.numpy(), whole[0]) < 1e-6
    assert _rel(st.numpy(), whole[1]) < 1e-6


def _recurrence64(xh, dt, a_log, Bc, Cc, s0=None):
    """y_t = C_t·S_t, S_t = a_t·S_{t-1} + dt_t·x_t ⊗ B_t, in float64, one
    token at a time (no chunking)."""
    B, S, H, P = xh.shape
    G, N = Bc.shape[2:]
    rep = H // G
    xh, dt, Bc, Cc = (np.asarray(t, np.float64) for t in (xh, dt, Bc, Cc))
    a = np.exp(-dt * np.exp(np.asarray(a_log, np.float64)))   # (B, S, H)
    st = np.zeros((B, H, P, N)) if s0 is None else np.asarray(s0, np.float64)
    Bh, Ch = np.repeat(Bc, rep, axis=2), np.repeat(Cc, rep, axis=2)
    ys = np.empty((B, S, H, P))
    for t in range(S):
        st = st * a[:, t, :, None, None] + np.einsum(
            "bhp,bhn->bhpn", xh[:, t] * dt[:, t, :, None], Bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", st, Ch[:, t])
    return ys, st


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_float64_recurrence(groups):
    rng = np.random.default_rng(5 + groups)
    B, S, H, P, N = 2, 256, 4, 8, 16
    inp = _ssd_inputs(rng, B, S, H, P, groups, N)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    y, st = ssm.ssd_chunked(**{k: _t(v) for k, v in inp.items()},
                            init_state=_t(s0))
    wy, wst = _recurrence64(**inp, s0=s0)
    assert _rel(y.numpy(), wy) < TOL
    assert _rel(st.numpy(), wst) < TOL


@pytest.mark.parametrize("S", [33, 128, 200])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_ssm_matches_reference(S, groups, with_state):
    """The mixer's output, final state and conv window; a ragged S pads
    after softplus, so the final state is the state after the last real
    token."""
    cfg, jcfg = _cfgs(groups)
    rng = np.random.default_rng(S * 7 + groups + with_state)
    p = _layer(cfg, rng)
    d_in, H, P, N, G = ssm.dims(cfg)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    s0 = (rng.normal(size=(2, H, P, N)).astype(np.float32)
          if with_state else None)
    out, st, window = ssm.apply_ssm(
        cfg, {k: _t(v) for k, v in p.items()}, _t(x),
        init_state=None if s0 is None else _t(s0))
    jout, jst = jssm.apply_ssm(jcfg, {k: _j(v) for k, v in p.items()}, _j(x),
                               init_state=None if s0 is None else _j(s0))
    assert out.shape == (2, S, cfg.d_model) and st.shape == (2, H, P, N)
    assert _rel(out.numpy(), jout) < TOL
    assert _rel(st.numpy(), jst) < TOL
    zxbcdt = x @ p["in_proj"]               # [z, x, B, C, dt]: x, B, C
    want_window = zxbcdt[:, -(cfg.ssm_conv - 1):, d_in:2 * d_in + 2 * G * N]
    assert _rel(window.numpy(), want_window) < TOL


def test_apply_ssm_decode_matches_reference():
    """One decode step from a random cache: output, rolled conv window and
    state; the port writes the cache in place."""
    for groups in (1, 2):
        cfg, jcfg = _cfgs(groups)
        rng = np.random.default_rng(20 + groups)
        p = _layer(cfg, rng)
        d_in, H, P, N, G = ssm.dims(cfg)
        x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        conv = rng.normal(size=(3, cfg.ssm_conv - 1,
                                d_in + 2 * G * N)).astype(np.float32)
        state = rng.normal(size=(3, H, P, N)).astype(np.float32)
        cache = {"conv": _t(conv.copy()), "state": _t(state.copy())}
        out, got = ssm.apply_ssm_decode(
            cfg, {k: _t(v) for k, v in p.items()}, _t(x), cache)
        jout, want = jssm.apply_ssm_decode(
            jcfg, {k: _j(v) for k, v in p.items()}, _j(x),
            {"conv": _j(conv), "state": _j(state)})
        assert got is cache
        assert _rel(out.numpy(), jout) < TOL
        for k in ("conv", "state"):
            assert got[k].shape == want[k].shape
            assert _rel(got[k].numpy(), want[k]) < TOL


def test_init_ssm_cache_matches_reference():
    cfg, jcfg = _cfgs(2)
    got = ssm.init_ssm_cache(cfg, 3, torch.bfloat16, "cpu")
    want = jssm.init_ssm_cache(jcfg, 3, jnp.bfloat16)
    for k in ("conv", "state"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()


def _overflow_inputs():
    rng = np.random.default_rng(3)
    return _ssd_inputs(rng, 1, 128, 2, 4, 1, 4, dt=0.7) | {
        "a_log": np.zeros(2, np.float32)}


def test_overflow_chunk_forward_equals_reference_and_is_finite():
    """dt = 0.7, A_log = 0 over one 128-token chunk: the reference's
    exp(cum_t - cum_s) reaches exp(88.9) above the diagonal, past float32's
    largest; its forward selects 0 there.  The port masks the exponent:
    the same forward, finite."""
    inp = _overflow_inputs()
    cum = np.cumsum(-inp["dt"][0, :, 0].astype(np.float64))
    assert cum[0] - cum[-1] > np.log(np.finfo(np.float32).max)
    y, st = ssm.ssd_chunked(**{k: _t(v) for k, v in inp.items()})
    jy, jst = jssm.ssd_chunked(**{k: _j(v) for k, v in inp.items()})
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert np.isfinite(np.asarray(jy)).all()
    assert _rel(y.numpy(), jy) < TOL
    assert _rel(st.numpy(), jst) < TOL


def test_overflow_chunk_gradient_finite_in_port_nan_in_reference():
    """The gradient of y.sum() with respect to every input: finite in the
    port.  In the reference (inf·0 in the masked product's backward,
    ROADMAP §C) dt's gradient is NaN in all its 256 entries and A_log's in
    both; xh's stays finite."""
    inp = _overflow_inputs()
    ts = {k: _t(v).requires_grad_(True) for k, v in inp.items()}
    ssm.ssd_chunked(**ts)[0].sum().backward()
    for k, t in ts.items():
        assert torch.isfinite(t.grad).all(), k

    def jloss(xh, dt, a_log, Bc, Cc):
        return jssm.ssd_chunked(xh, dt, a_log, Bc, Cc)[0].sum()
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(_j(inp[k]) for k in ("xh", "dt", "a_log", "Bc", "Cc")))
    dtg, ag = np.asarray(jg[1]), np.asarray(jg[2])
    assert dtg.size == 256 and np.isnan(dtg).all()
    assert np.isnan(ag).all() and np.isfinite(np.asarray(jg[0])).all()


def test_init_ssm_tree_and_law():
    """Keys and shapes of the reference's ``init_ssm``; in_proj and
    out_proj N(0, fan_in^-1), conv_w N(0, 1/ssm_conv), conv_b, A_log and
    dt_bias zeros, D and norm ones; ``stack`` adds a leading axis."""
    cfg, jcfg = _cfgs(2)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_ssm(cfg, gen)
    jp, _ = tree_unbox(jssm.init_ssm(jcfg, keygen(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    d_in = ssm.dims(cfg)[0]
    assert abs(float(p["in_proj"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(p["out_proj"].std()) * d_in ** 0.5 - 1) < 0.05
    assert abs(float(p["conv_w"].std()) * cfg.ssm_conv ** 0.5 - 1) < 0.1
    for k in ("conv_b", "A_log", "dt_bias"):
        assert not p[k].any(), k
    for k in ("D", "norm"):
        assert torch.equal(p[k], torch.ones_like(p[k])), k
    stacked = ssm.init_ssm(cfg, None, stack=3)
    assert {t.device.type for t in stacked.values()} == {"meta"}
    assert all(stacked[k].shape == (3,) + p[k].shape for k in p)
