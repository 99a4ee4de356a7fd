"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``.

Reduced qwen3-moe-30b-a3b (``reduced_for_smoke``: d_model 128, 8 experts,
top-2, expert d_ff 64, float32), the reference's ``init_moe`` parameters
carried across as numpy arrays, the same x (2, S, 128) from a seeded numpy
RNG through both ``apply_moe``:

* the output and the load-balancing loss within 1e-5 of their largest
  entry, with SwiGLU and GELU experts and with Arctic's dense residual;
* dropless (S·k <= 4096: every pair kept), capacity-bound (S = 2100, S·k
  > 4096, a router skewed to the last experts, so pairs drop), and all
  gates tied (a zero router: every token picks experts 0 and 1, as
  ``jax.lax.top_k`` does);
* the pairs each package keeps — read from the reference's dispatch
  buffer (``hint``'s first call) and from the port's ``route_hook`` —
  equal exactly;
* the gradients of Σ y·dy + aux with respect to x and every parameter
  against ``jax.grad``, within 1e-4 of each one's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_for_smoke as jreduced
from repro.models import moe as jmoe
from repro.models.base import keygen, tree_unbox
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.models import moe, zoo

B = 2
S_DROPLESS, S_BOUND = 48, 2100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfgs(arch="qwen3-moe-30b-a3b", **over):
    return (dataclasses.replace(jreduced(jget_config(arch)), **over),
            dataclasses.replace(reduced_for_smoke(get_config(arch)), **over))


def _setup(routing, arch="qwen3-moe-30b-a3b", **over):
    """(reference cfg, port cfg, numpy params, numpy x) for one routing
    case."""
    jcfg, cfg = _cfgs(arch, **over)
    p, _ = tree_unbox(jmoe.init_moe(jcfg, keygen(jax.random.PRNGKey(3))))
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)
    rng = np.random.default_rng(7)
    S = S_BOUND if routing == "bound" else S_DROPLESS
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if routing == "bound":
        # feature 0 a constant 3 that the router reads with weights rising
        # over the experts: the last ones take most of the pairs
        x[..., 0] = 3.0
        p["router"][0] = np.linspace(0.0, 2.0, cfg.n_experts)
    elif routing == "tied":
        p["router"][:] = 0.0
    return jcfg, cfg, p, x


def _reference(jcfg, p, x):
    """The reference's (y, aux) and its dispatch buffer (B, E, C, d)."""
    seen = []

    def hint(t, axes):
        seen.append(t)
        return t
    saved, jmoe.hint = jmoe.hint, hint
    try:
        y, aux = jmoe.apply_moe(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x))
    finally:
        jmoe.hint = saved
    return np.asarray(y), float(aux), np.asarray(seen[0])


def _port(cfg, p, x):
    routes = []
    saved, moe.route_hook = moe.route_hook, lambda sel, keep: routes.append(
        (sel.clone(), keep.clone()))
    try:
        y, aux = moe.apply_moe(cfg, {k: _t(v) for k, v in p.items()},
                               torch.from_numpy(x))
    finally:
        moe.route_hook = saved
    return y.numpy(), float(aux), routes[0]


def _t(v):
    if isinstance(v, dict):
        return {k: _t(a) for k, a in v.items()}
    return torch.from_numpy(np.array(v))


def _ref_kept(buf, x):
    """{(row, token, expert)} of the reference's dispatch buffer: each
    nonzero slot holds one token's row of x."""
    kept = set()
    for b in range(buf.shape[0]):
        rows = {x[b, s].tobytes(): s for s in range(x.shape[1])}
        for e in range(buf.shape[1]):
            for c in range(buf.shape[2]):
                slot = buf[b, e, c]
                if slot.any():
                    kept.add((b, rows[slot.tobytes()], e))
    return kept


def _port_kept(sel, keep, k):
    sel, keep = sel.reshape(B, -1).numpy(), keep.numpy()
    return {(b, j // k, int(sel[b, j])) for b, j in zip(*np.nonzero(keep))}


CASES = [("dropless", {}), ("bound", {}), ("tied", {}),
         ("dropless", {"act": "gelu"}), ("bound", {"act": "gelu"}),
         ("dropless", {"act": "geglu"}), ("bound", {"arch": "arctic-480b"}),
         ("dropless", {"arch": "arctic-480b"})]


@pytest.mark.parametrize("routing,over", CASES,
                         ids=[f"{r}-{'-'.join(o.values()) or 'swiglu'}"
                              for r, o in CASES])
def test_apply_moe_matches_reference(routing, over):
    jcfg, cfg, p, x = _setup(routing, **over)
    assert ("wg" in p) == (cfg.act != "gelu")
    assert ("dense" in p) == cfg.dense_residual
    jy, jaux, jbuf = _reference(jcfg, p, x)
    y, aux, (sel, keep) = _port(cfg, p, x)
    assert y.shape == x.shape
    assert _rel(y, jy) < 1e-5
    assert abs(aux - jaux) <= 1e-5 * abs(jaux)
    k = cfg.top_k
    S = x.shape[1]
    assert moe._capacity(cfg, S) == jmoe._capacity(jcfg, S) == jbuf.shape[2]
    kept = _port_kept(sel, keep, k)
    assert kept == _ref_kept(jbuf, x)
    if routing == "bound":
        assert S * k > 4096 and len(kept) < B * S * k      # pairs dropped
    else:
        assert len(kept) == B * S * k                       # dropless
    if routing == "tied":
        assert (sel.numpy() == np.arange(k)).all()          # lowest index


def test_capacity_matches_reference():
    jcfg, cfg = _cfgs()
    full_j, full = (jget_config("qwen3-moe-30b-a3b"),
                    get_config("qwen3-moe-30b-a3b"))
    for tokens in (1, 7, 33, 511, 512, 513, 2048, 2049, 4096, 4097, 32768):
        assert moe._capacity(cfg, tokens) == jmoe._capacity(jcfg, tokens)
        assert moe._capacity(full, tokens) == jmoe._capacity(full_j, tokens)
    assert moe._capacity(full, 4096) == 320 and moe._capacity(full, 1) == 8


GRAD_CASES = [("dropless", {}), ("bound", {}), ("dropless", {"act": "gelu"}),
              ("bound", {"arch": "arctic-480b"})]


@pytest.mark.parametrize("routing,over", GRAD_CASES,
                         ids=[f"{r}-{'-'.join(o.values()) or 'swiglu'}"
                              for r, o in GRAD_CASES])
def test_apply_moe_gradients_match_reference(routing, over):
    jcfg, cfg, p, x = _setup(routing, **over)
    dy = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.apply_moe(jcfg, params, xx)
        return jnp.sum(y * dy) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = _t(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    flat = dict(zoo.flatten(tp))
    for t in flat.values():
        t.requires_grad_(True)
    y, aux = moe.apply_moe(cfg, tp, tx)
    ((y * torch.from_numpy(dy)).sum() + aux).backward()
    want = dict(zoo.flatten(jax.tree_util.tree_map(np.asarray, jgp)))
    assert set(want) == set(flat)
    assert _rel(tx.grad.numpy(), np.asarray(jgx)) < 1e-4
    for name, t in flat.items():
        assert t.grad is not None and t.grad.shape == t.shape, name
        assert _rel(t.grad.numpy(), want[name]) < 1e-4, name


def test_init_moe_tree_and_law():
    """The port's tree has the reference's keys and shapes; each expert
    leaf is N(0, 1/E): the reference's fan_in is shape[0] of the 3-D leaf,
    the expert count, and the port keeps that law."""
    jcfg, cfg = _cfgs("arctic-480b")
    jp, _ = tree_unbox(jmoe.init_moe(jcfg, keygen(jax.random.PRNGKey(0))))
    gen = torch.Generator().manual_seed(0)
    tp = moe.init_moe(cfg, gen)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    big = dataclasses.replace(cfg, moe_d_ff=512)
    wi = moe.init_moe(big, gen)["wi"]
    assert abs(float(wi.std()) * cfg.n_experts ** 0.5 - 1) < 0.05
