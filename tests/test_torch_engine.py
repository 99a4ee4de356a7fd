"""The port's engine held against the JAX package's: the same ``fm``
programs on the same numpy inputs give the same outputs, the same plan
counters (passes, partition_steps, epilogue_launches, plan-cache hits and
misses) and the same kernel dispatch — ``pallas`` in the reference, ``cuda``
in the port (whose kernel wrappers run their plain versions on the CPU) —
plus the port's own contracts: no JAX inside it, CUDA by default and never a
silent fall back to the CPU."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from helpers_twin import data_dirs, time_limit  # noqa: F401
from repro.core import fm as jfm
from repro.core import materialize as jmz
from repro.core.fusion import Plan as JPlan
from repro.algorithms.glm import glm_irls_outputs as j_glm_outputs
from repro.algorithms.gmm import gmm_iteration as j_gmm_iteration
from repro.observability import metrics as jmetrics
from repro_torch.algorithms.glm import glm_irls_outputs as t_glm_outputs
from repro_torch.algorithms.gmm import gmm_moment_outputs
from repro_torch.core import fm as tfm
from repro_torch.core import lowering as tlowering
from repro_torch.core import materialize as tmz
from repro_torch.core.fusion import Plan as TPlan
from repro_torch.observability import metrics as tmetrics

pytestmark = pytest.mark.usefixtures("time_limit")

RNG = np.random.default_rng(17)

COUNTERS = ("materialize_calls", "passes", "partition_steps",
            "epilogue_launches", "epilogue_host_inputs", "plan_cache_hits",
            "plan_cache_misses")


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    with tfm.conf(device="cpu"):
        yield
    tmetrics.REGISTRY.reset()
    tmz.clear_plan_cache()


@pytest.fixture(autouse=True)
def _fresh():
    jmz.clear_plan_cache()
    tmz.clear_plan_cache()
    jmetrics.REGISTRY.reset()
    tmetrics.REGISTRY.reset()
    yield


# -- the programs: fm → (list of lazy outputs), over the same numpy inputs --

def _scale_gram(fm, X, y, C):
    return [fm.crossprod(fm.scale(X))]


def _summary_sinks(fm, X, y, C):
    return [fm.colMins(X), fm.colMaxs(X), fm.colSums(X),
            fm.colSums(fm.abs_(X)), fm.colSums(X ** 2),
            fm.agg_col(X, "count_nonzero")]


def _correlation_sinks(fm, X, y, C):
    return [fm.crossprod(X), fm.colSums(X)]


def _lloyd_step(fm, X, y, C):
    D = fm.inner_prod(X, C.T, "squared_diff", "sum")
    labels = fm.which_min_row(D)
    return [fm.rowsum(X, labels, C.shape[0]), fm.table_(labels, C.shape[0]),
            fm.sum_(fm.rowMins(D)), labels]


def _glm_iteration(fm, X, y, C):
    outputs = t_glm_outputs if fm is tfm else j_glm_outputs
    beta = np.linspace(-0.5, 0.5, X.ncol)
    beta_next, ll, _, _ = outputs(X, y, beta, "logistic")
    return [beta_next, ll]


def _glm_iteration_ridge(fm, X, y, C):
    outputs = t_glm_outputs if fm is tfm else j_glm_outputs
    beta_next, ll, _, _ = outputs(X, y, np.zeros(X.ncol), "logistic",
                                  ridge=1e-2)
    return [beta_next, ll]


def _xty(fm, X, y, C):
    return [fm.crossprod(X, y), fm.colSums(X)]


def _nmf_pass_a(fm, X, y, C):
    """nmf's pass A (algorithms/nmf.py): WᵀX and WᵀW over a tall W."""
    W = fm.conv_R2FM(np.abs(fm.as_np(X)[:, :3]) + 0.1)
    return [fm.crossprod(W, fm.abs_(X)), fm.crossprod(W)]


def _gmm_moments(fm, X, y, C):
    """gmm's E-step sinks at k = 3 (algorithms/gmm.py)."""
    means = np.asarray(C, np.float64)
    covs = np.tile(np.eye(X.ncol) * 4.0, (3, 1, 1))
    weights = np.array([0.2, 0.3, 0.5])
    if fm is tfm:
        return gmm_moment_outputs(X, weights, means, covs)
    return _j_gmm_sinks(X, weights, means, covs)


def _j_gmm_sinks(X, weights, means, covs):
    """The reference's gmm_iteration builds its sinks inline: capture them
    by running it with fm.materialize swapped for a recorder."""
    captured = []

    def grab(*outs, **kw):
        captured.extend(outs)
        raise _Captured

    real = jfm.materialize
    jfm.materialize = grab
    try:
        j_gmm_iteration(X, weights, means, covs)
    except _Captured:
        pass
    finally:
        jfm.materialize = real
    return captured


class _Captured(Exception):
    pass


def _one_hot(fm, n):
    """The same one-hot design in both packages, on the device tier."""
    rng = np.random.default_rng(31)
    levels = (7, 5, 11)
    codes = [rng.integers(0, lv, n) for lv in levels]
    return fm.one_hot(*[fm.as_factor(c, lv) for c, lv in zip(codes, levels)],
                      host=False)


def _sparse_glm(fm, X, y, C):
    outputs = t_glm_outputs if fm is tfm else j_glm_outputs
    Xs = _one_hot(fm, y.nrow)
    beta = np.linspace(-0.3, 0.3, Xs.ncol)
    # A one-hot design is rank-deficient (each factor's columns sum to 1):
    # at a tiny ridge the Newton step along the null space is set by the
    # ridge alone and f32 sums taken in another order move it by ~1e-3.  A
    # unit ridge keeps the step well conditioned for the 1e-4 comparison.
    beta_next, ll, _, _ = outputs(Xs, y, beta, "logistic", ridge=1.0)
    return [beta_next, ll]


def _sparse_gram(fm, X, y, C):
    Xs = _one_hot(fm, y.nrow)
    return [fm.crossprod(Xs), fm.crossprod(Xs, X)]


PROGRAMS = {"scale_gram": (_scale_gram, 2), "summary": (_summary_sinks, 1),
            "correlation": (_correlation_sinks, 1),
            "lloyd": (_lloyd_step, 1), "glm": (_glm_iteration, 1),
            "glm_ridge": (_glm_iteration_ridge, 1), "xty": (_xty, 1),
            "nmf_pass_a": (_nmf_pass_a, 1), "gmm_moments": (_gmm_moments, 1),
            "sparse_glm": (_sparse_glm, 1),
            "sparse_gram": (_sparse_gram, 1)}


def _inputs():
    X = (RNG.normal(size=(512, 6)) * 2 + 0.5).astype(np.float32)
    y = (RNG.uniform(size=512) < 0.4).astype(np.float32)
    C = X[[3, 100, 400]].copy()
    return X, y, C


def _run(fm, program, backend, X, y, C, repeats=2):
    outs = None
    for _ in range(repeats):
        lazy = program(fm, fm.conv_R2FM(X), fm.conv_R2FM(y), C)
        outs = [fm.as_np(o) for o in fm.materialize(*lazy, backend=backend)]
    return outs


def _kernels(fm, Plan, program, backend, X, y, C):
    lazy = program(fm, fm.conv_R2FM(X), fm.conv_R2FM(y), C)
    return sorted(u.kernel for u in
                  Plan([o.m for o in lazy]).program(backend).kernel_units)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("xla", "torch")],
                         ids=["kernels", "generic"])
def test_same_program_same_outputs_counters_and_dispatch(name, backends):
    program, passes = PROGRAMS[name]
    jb, tb = backends
    X, y, C = _inputs()
    ref = _run(jfm, program, jb, X, y, C)
    got = _run(tfm, program, tb, X, y, C)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    js, ts = jmz.exec_stats(), tmz.exec_stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["passes"] == 2 * passes
    jk = _kernels(jfm, JPlan, program, jb, X, y, C)
    tk = _kernels(tfm, TPlan, program, tb, X, y, C)
    assert tk == jk


def test_dispatch_report_names_kernels_and_declines():
    X, y, C = _inputs()
    Xt = tfm.conv_R2FM(X)
    plan = TPlan([tfm.crossprod(Xt, tfm.conv_R2FM(X[:, :2])).m,
                  tfm.colSums(tfm.abs_(Xt)).m,
                  tfm.inner_prod(Xt.T, Xt, "squared_diff", "sum").m])
    report = tlowering.dispatch_report(plan, plan.ir, "cuda")
    text = " | ".join(report[s] for s in sorted(report))
    assert "cuda:fused_apply_agg (claimed by match_apply_agg)" in text
    assert "cuda:xty (claimed by match_contractions)" in text
    assert "declined: (squared_diff,sum) semiring" in text
    generic = tlowering.dispatch_report(plan, plan.ir, "torch")
    assert set(generic.values()) == {"torch generic rules"}


def test_dispatch_report_names_spmm_claims_and_sparse_declines():
    n = 200
    Xs = _one_hot(tfm, n)
    y = tfm.conv_R2FM(np.ones((n, 1), np.float32))
    beta_next, ll, _, _ = t_glm_outputs(Xs, y, np.zeros(Xs.ncol), "logistic")
    plan = TPlan([beta_next.m, ll.m, tfm.crossprod(Xs).m])
    text = " | ".join(tlowering.dispatch_report(plan, plan.ir, "cuda").values())
    for kernel in ("spmm_gram", "spmm_xty", "spmm_wgram"):
        assert f"cuda:{kernel} (claimed by match_spmm)" in text
    plan = TPlan([tfm.inner_prod(Xs.T, Xs, "mul", "max").m,
                  tfm.colSums(Xs).m])
    text = " | ".join(tlowering.dispatch_report(plan, plan.ir, "cuda").values())
    assert "spmm covers (mul,sum) only" in text
    assert "sparse source: fused_apply_agg" in text


def test_step_frees_values_after_their_last_reader(monkeypatch):
    """The liveness rule: the GMM E-step's full-height temporaries (Z_j, Y_j,
    Y_j², …) leave the step's values as soon as nothing later reads them,
    and dropping them changes neither the outputs nor the counters."""
    X, y, C = _inputs()
    Xt = tfm.conv_R2FM(X)
    for backend in ("cuda", "torch"):
        outs = _gmm_moments(tfm, Xt, None, C)
        prog = TPlan([o.m for o in outs]).program(backend)
        keep = {n.id for n in prog.plan.row_local_roots + prog.plan.saves}
        made = {n.id for u in prog.units if u.kernel is None
                for n in u.nodes if not n.is_sink}
        freed = [v for ids in prog.release.values() for v in ids]
        assert len(freed) == len(set(freed))
        assert made - keep <= set(freed)
        got = []
        for keep_all in (False, True):
            tmz.clear_plan_cache()
            tmetrics.REGISTRY.reset()
            with monkeypatch.context() as m:
                if keep_all:
                    m.setattr(tlowering, "_release_plan", lambda *a: {})
                res = tfm.materialize(*_gmm_moments(tfm, Xt, None, C),
                                      backend=backend)
                assert bool(tmz._PLANS) and all(
                    bool(pl.program(backend).release) != keep_all
                    for pl in tmz._PLANS.values())
            got.append(([tfm.as_np(r) for r in res], tmz.exec_stats()))
        (a, sa), (b, sb) = got
        assert sa == sb
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_lloyd_iterations_reuse_one_cached_plan():
    X, y, _ = _inputs()
    Xt = tfm.conv_R2FM(X)
    for it in range(3):
        C = RNG.normal(size=(3, 6)).astype(np.float32)
        tfm.materialize(*_lloyd_step(tfm, Xt, None, C), backend="cuda")
    st = tmz.exec_stats()
    assert (st["plan_cache_misses"], st["plan_cache_hits"]) == (1, 2)


def test_later_slices_raise_with_their_roadmap_item(tmp_path, data_dirs):
    """What A7a-ii, A7b, A12, A13 and A14 brought — a prefetched ``ooc``
    stream, ``fm.one_hot``'s host slab, factor ingest,
    ``fm.persist(tier="disk")``, ``fm.serve``, meshes, ``Model.forward``
    and the LM mesh's ``replan_mesh`` (A14a; it raised naming A14 before)
    — runs (and equals the reference where it is compared here), and a
    mesh that is no mesh (``set_conf``, ``fm.batch``, ``fm.Engine``)
    raises the reference's exception type."""
    X, _, _ = _inputs()
    Xt = tfm.conv_R2FM(X)
    Xh = tfm.conv_R2FM(X, host=True)
    (s,) = tfm.materialize(tfm.colSums(Xh), mode="ooc", prefetch=True)
    (js,) = jfm.materialize(jfm.colSums(jfm.conv_R2FM(X, host=True)),
                            mode="ooc", prefetch=True)
    np.testing.assert_allclose(tfm.as_np(s), jfm.as_np(js), rtol=1e-6)
    H = tfm.one_hot(tfm.as_factor(np.arange(4)))
    assert H.m.is_sparse and H.m.on_host
    np.testing.assert_array_equal(
        tfm.as_np(H), jfm.as_np(jfm.one_hot(jfm.as_factor(np.arange(4)))))
    csv = tmp_path / "f.csv"
    csv.write_text("0\n2\n1\n")
    for f in (jfm, tfm):
        F = f.load_factor_matrix(str(csv), "f", num_levels=[3])
        np.testing.assert_array_equal(f.as_np(F), np.eye(3)[[0, 2, 1]])
        (c,) = f.materialize(f.persist(f.colSums(f.conv_R2FM(X)),
                                       tier="disk"))
        np.testing.assert_allclose(f.as_np(c).ravel(), X.sum(0), rtol=1e-5)
        assert f.persist(f.conv_R2FM(X), tier="disk").m.on_disk
    with tfm.serve(window_ms=1) as eng:
        h = eng.submit(tfm.colSums(Xt))
        np.testing.assert_allclose(tfm.as_np(h.result(timeout=60)).ravel(),
                                   X.sum(0), rtol=1e-5)
    def served(f, X):
        with f.Engine(window_ms=1, mesh=object()) as eng:
            eng.submit(f.colSums(X)).result(timeout=60)

    Xj = jfm.conv_R2FM(X)
    for call in (lambda f, X: f.set_conf(mesh=object()),
                 lambda f, X: f.batch(f.colSums(X), mesh=object()),
                 served):
        with pytest.raises(Exception) as want:
            call(jfm, Xj)
        with pytest.raises(want.type):
            call(tfm, Xt)
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models import zoo
    from repro_torch.runtime import replan_mesh
    model = zoo.build(reduced_for_smoke(get_config("llama3.2-3b")),
                      device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    loss, _ = model.forward(model.init(0), {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    mesh = replan_mesh(1)
    assert mesh.devices.shape == (1, 1)
    assert mesh.axis_names == ("data", "model")


def test_conf_knobs_mirror_the_reference():
    from repro.storage import registry as jreg
    from repro_torch.storage import registry as treg
    assert set(treg.KNOWN_KNOBS) == set(jreg.KNOWN_KNOBS) | {"device"}
    with pytest.raises(ValueError, match="did you mean 'backend'"):
        tfm.set_conf(backnd="cuda")
    with tfm.conf(backend="torch", vmem_partition_bytes=1 << 16):
        assert treg.get_conf("backend") == "torch"
        assert tlowering.resolve_backend("auto") == "torch"
    assert treg.get_conf("backend") == "auto"


def test_auto_backend_follows_the_device():
    assert tlowering.resolve_backend("auto") == "torch"   # device is cpu here
    if not torch.cuda.is_available():
        with tfm.conf(device="cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tlowering.resolve_backend("auto")


def test_default_device_without_cuda_raises():
    """With no card and no request for the CPU, conv_R2FM and materialize
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    X = np.ones((8, 2), np.float32)
    lazy = tfm.colSums(tfm.conv_R2FM(X))
    lazy_host = tfm.colSums(tfm.conv_R2FM(X, host=True))
    with tfm.conf(device="cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            tfm.conv_R2FM(X)
        with pytest.raises(RuntimeError, match="is_available"):
            tfm.materialize(lazy)
        # the host tier too: its partitions would stage to the card
        with pytest.raises(RuntimeError, match="is_available"):
            tfm.conv_R2FM(X, host=True)
        with pytest.raises(RuntimeError, match="is_available"):
            tfm.one_hot(tfm.as_factor(np.arange(4)))
        for mode in ("ooc", "stream", "auto"):
            with pytest.raises(RuntimeError, match="is_available"):
                tfm.materialize(lazy_host, mode=mode)


def test_dtype_canon_matches_the_reference():
    from repro.core import dtypes as jd
    from repro_torch.core import dtypes as td
    for name in ("bool", "int8", "int16", "int32", "int64", "uint8",
                 "float16", "bfloat16", "float32", "float64"):
        assert td.name(td.canon(name)) == jd.canon(name).name, name
        assert td.np_equiv(name) == jd.np_equiv(name), name
    for a in ("bool", "int32", "bfloat16", "float64"):
        for b in ("int8", "float32", "int64"):
            assert td.name(td.promote(a, b)) == jd.promote(a, b).name
    X = np.arange(12, dtype=np.int64).reshape(6, 2)
    assert tfm.conv_R2FM(X).dtype == torch.int32
    assert tfm.conv_R2FM(X.astype(np.float64)).dtype == torch.float32


def test_port_imports_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from repro_torch.core import fm
        from repro_torch import algorithms
        from repro_torch.kernels import (build, flash_attention,
                                         fused_apply_agg, gram,
                                         kmeans_assign, ops, spmm,
                                         weighted_gram)
        from repro_torch.storage import prefetch, sparse
        from repro_torch import configs, models, runtime
        from repro_torch.checkpoint import checkpoint
        from repro_torch.distributed import sharding
        from repro_torch.launch import mesh, steps, train
        from repro_torch.models import layers, moe, transformer, zoo
        from repro_torch.optim import adam, compression
        from repro_torch.runtime import fault_tolerance
        for arch in configs.PORTED_IDS:
            configs.get_config(arch)
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
