"""The port's algorithms (summary, correlation, tall SVD, PCA,
logistic/gaussian/poisson GLM, k-means, GMM, NMF, naive Bayes) on the
fixtures of tests/test_algorithms.py, at that file's tolerances, under both
of the port's backends on the CPU — and against the JAX package's own
results on the same numpy inputs.

The reference's ``host=True`` cells (its inputs in host RAM, streamed out
of core) are ``test_host_tier_cells``: the same test bodies with the
inputs on the host tier in both packages, staged by the background
prefetcher where the conf default turns it on, as in the reference.
``test_host_tier_counters_equal_the_reference`` holds the plan counters of
each algorithm's run from host RAM, prefetched in both packages, to the
reference's, and ``test_disk_tier_counters_equal_the_reference`` the same
from ``.fmat`` files.  The reference's disk cells:
``test_glm_logistic_ooc_disk_one_pass_and_wgram_dispatch`` and
``test_nmf_disk_spill`` (the superseded spill files reclaimed)."""
import inspect

import numpy as np
import pytest
import torch

from repro import algorithms as jalg
from repro_torch import algorithms as talg
from repro.core import fm as jfm
from repro_torch.algorithms import (correlation, glm, glm_iteration_plan,
                                    glm_predict, gmm, kmeans, naive_bayes,
                                    nb_predict, nmf, pca, summary, svd_tall)
from repro_torch.algorithms.kmeans import _init_centers, kmeans_iteration
from repro_torch.core import fm
from repro_torch.kernels import kmeans_assign as ka
from repro_torch.observability import metrics

from helpers_twin import PORT, REF, both_conf, counting, data_dirs  # noqa: F401
from helpers_twin import time_limit  # noqa: F401

pytestmark = pytest.mark.usefixtures("time_limit")

RNG = np.random.default_rng(11)
BACKENDS = ["torch", "cuda"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    with fm.conf(device="cpu"):
        metrics.REGISTRY.reset()
        yield
        metrics.REGISTRY.reset()


@pytest.fixture(params=BACKENDS)
def backend(request):
    with fm.conf(backend=request.param):
        yield request.param


@pytest.fixture(scope="module")
def X_np():
    return (RNG.normal(size=(3000, 10)) * 2 + 1).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    centers = RNG.normal(size=(5, 8)) * 12
    pts = np.concatenate([c + RNG.normal(size=(400, 8)) for c in centers])
    return pts.astype(np.float32), centers


@pytest.fixture(scope="module")
def logit_data():
    X = RNG.normal(size=(4000, 6)).astype(np.float32)
    true_beta = np.array([1.5, -2.0, 0.5, 0.0, 1.0, -0.5])
    pvec = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ true_beta)))
    y = (RNG.uniform(size=4000) < pvec).astype(np.float32)
    return X, y


def test_summary(X_np, backend, host=False):
    s = summary(fm.conv_R2FM(X_np, host=host))
    np.testing.assert_allclose(s.mean, X_np.mean(0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, X_np.var(0, ddof=1), rtol=1e-2)
    np.testing.assert_allclose(s.col_min, X_np.min(0))
    np.testing.assert_allclose(s.col_max, X_np.max(0))
    np.testing.assert_allclose(s.l1, np.abs(X_np).sum(0), rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, (X_np != 0).sum(0))
    r = jalg.summary(jfm.conv_R2FM(X_np, host=host))
    for f in ("col_min", "col_max", "mean", "l1", "l2", "nnz", "var"):
        np.testing.assert_allclose(getattr(s, f), getattr(r, f), rtol=1e-5)


@pytest.mark.parametrize("two_pass", [False, True])
def test_correlation(X_np, backend, two_pass, host=False):
    c = correlation(fm.conv_R2FM(X_np, host=host), two_pass=two_pass)
    np.testing.assert_allclose(c, np.corrcoef(X_np.T), rtol=2e-2, atol=2e-3)
    r = jalg.correlation(jfm.conv_R2FM(X_np, host=host), two_pass=two_pass)
    np.testing.assert_allclose(c, r, rtol=1e-4, atol=1e-5)


def test_kmeans_recovers_blobs(blobs, backend, host=False):
    pts, centers = blobs
    res = kmeans(fm.conv_R2FM(pts, host=host), k=5, max_iter=30, seed=1)
    d = np.linalg.norm(res.centers[:, None] - centers[None], axis=-1)
    assert (d.min(1) < 1.0).all()
    assert res.wss < pts.shape[0] * 8 * 2.0
    r = jalg.kmeans(jfm.conv_R2FM(pts, host=host), k=5, max_iter=30, seed=1)
    np.testing.assert_allclose(res.centers, r.centers, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.wss, r.wss, rtol=1e-4)
    np.testing.assert_array_equal(fm.as_np(res.labels), jfm.as_np(r.labels))


def test_kmeans_matches_kernel(blobs):
    """The fused GenOps iteration and the kernel wrapper agree."""
    pts, _ = blobs
    X = fm.conv_R2FM(pts)
    C = _init_centers(X, 5, 0)
    newC, counts, wss, _ = kmeans_iteration(X, C)
    lab_k, sums_k, cnt_k, wss_k = ka.kmeans_assign(torch.from_numpy(pts),
                                                   torch.from_numpy(C))
    np.testing.assert_allclose(cnt_k.numpy(), counts)
    np.testing.assert_allclose(float(wss_k[0]), wss, rtol=1e-3)
    c = cnt_k.numpy()[:, None]
    kernC = np.where(c > 0, sums_k.numpy() / np.maximum(c, 1), C)
    np.testing.assert_allclose(kernC, newC, rtol=1e-3, atol=1e-3)


def _numpy_irls_logistic(X, y, max_iter=25, tol=1e-8, w_eps=1e-6):
    beta = np.zeros(X.shape[1])
    Xf = X.astype(np.float64)
    prev = -np.inf
    for _ in range(max_iter):
        eta = Xf @ beta
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1 - mu) + w_eps
        z = eta + (y - mu) / w
        beta = np.linalg.solve(Xf.T @ (Xf * w[:, None]), Xf.T @ (w * z))
        ll = float(np.sum(y * eta - np.logaddexp(0.0, eta)))
        if np.isfinite(prev) and abs(ll - prev) <= tol * (abs(prev) + 1.0):
            break
        prev = ll
    return beta


def test_glm_logistic_matches_numpy_irls(logit_data, backend, host=False):
    X, y = logit_data
    res = glm(fm.conv_R2FM(X, host=host), fm.conv_R2FM(y, host=host),
              family="logistic")
    ref = _numpy_irls_logistic(X, y)
    np.testing.assert_allclose(res.beta, ref, rtol=1e-5, atol=1e-6)
    assert res.converged
    t = np.array(res.loglik_trace)
    assert (np.diff(t) > -1e-6 * np.abs(t[:-1])).all()
    r = jalg.glm(jfm.conv_R2FM(X, host=host), jfm.conv_R2FM(y, host=host),
                 family="logistic")
    np.testing.assert_allclose(res.beta, r.beta, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.loglik, r.loglik, rtol=1e-6)


def test_glm_iteration_is_one_pass_and_reaches_wgram(logit_data):
    X, y = logit_data
    Xf, yf = fm.conv_R2FM(X), fm.conv_R2FM(y)
    plan = glm_iteration_plan(Xf, yf, np.zeros(X.shape[1]), "logistic")
    assert plan.n_passes == 1 and len(plan.source_groups) == 2
    assert plan.bytes_in() == X.nbytes + y.nbytes
    kernels = sorted(u.kernel for u in plan.program("cuda").kernel_units)
    assert kernels == ["wgram"], plan.program("cuda").describe()


def test_glm_gaussian_is_ols(logit_data):
    X, _ = logit_data
    true_beta = np.array([0.5, 1.0, -1.0, 2.0, 0.0, -0.3])
    y = (X.astype(np.float64) @ true_beta
         + 0.01 * RNG.normal(size=X.shape[0])).astype(np.float32)
    res = glm(fm.conv_R2FM(X), fm.conv_R2FM(y), family="gaussian")
    ref = np.linalg.lstsq(X.astype(np.float64), y.astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(res.beta, ref, rtol=1e-4, atol=1e-5)
    assert res.iters == 1
    rss = float(((X.astype(np.float64) @ res.beta - y) ** 2).sum())
    np.testing.assert_allclose(res.loglik, -0.5 * rss, atol=0.05)


def test_glm_poisson(logit_data):
    X, _ = logit_data
    true_beta = np.array([0.3, -0.2, 0.1, 0.4, 0.0, -0.1])
    lam = np.exp(X.astype(np.float64) @ true_beta)
    y = RNG.poisson(lam).astype(np.float32)
    res = glm(fm.conv_R2FM(X), fm.conv_R2FM(y), family="poisson")
    np.testing.assert_allclose(res.beta, true_beta, atol=0.1)
    assert res.converged


def test_glm_singular_raises(logit_data):
    X, y = logit_data
    Xs = np.concatenate([X[:, :3], X[:, :1]], axis=1)
    with pytest.raises(np.linalg.LinAlgError, match="ridge"):
        glm(fm.conv_R2FM(Xs), fm.conv_R2FM(y), family="logistic")


def test_glm_standardized_first_iteration_two_passes(logit_data):
    X, y = logit_data
    fm.reset_exec_stats()
    res = glm(fm.conv_R2FM(X), fm.conv_R2FM(y), family="logistic",
              standardize=True, max_iter=1)
    assert fm.exec_stats()["passes"] == 2
    r = jalg.glm(jfm.conv_R2FM(X), jfm.conv_R2FM(y), family="logistic",
                 standardize=True, max_iter=1)
    np.testing.assert_allclose(res.beta, r.beta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.center, r.center, rtol=1e-5, atol=1e-6)


def test_glm_predict(logit_data):
    X, y = logit_data
    res = glm(fm.conv_R2FM(X), fm.conv_R2FM(y), family="logistic")
    (mu,) = fm.materialize(glm_predict(res, fm.conv_R2FM(X)))
    acc = ((fm.as_np(mu).reshape(-1) > 0.5) == (y > 0.5)).mean()
    assert acc > 0.8


def test_svd(X_np, backend, host=False):
    r = svd_tall(fm.conv_R2FM(X_np, host=host), k=6, compute_u=True)
    ref = np.linalg.svd(X_np.astype(np.float64), compute_uv=False)[:6]
    np.testing.assert_allclose(r.s, ref, rtol=1e-3)
    U = fm.as_np(r.U)
    np.testing.assert_allclose(U.T @ U, np.eye(6), atol=2e-2)
    np.testing.assert_allclose(X_np @ r.V, U @ np.diag(r.s),
                               rtol=1e-2, atol=1e-2)
    j = jalg.svd_tall(jfm.conv_R2FM(X_np, host=host), k=6)
    np.testing.assert_allclose(r.s, j.s, rtol=1e-5)


def test_pca_matches_numpy(X_np, backend, host=False):
    fm.reset_exec_stats()
    r = pca(fm.conv_R2FM(X_np, host=host), k=4, compute_scores=True)
    Xc = X_np.astype(np.float64) - X_np.mean(0)
    ref_s = np.linalg.svd(Xc, compute_uv=False)[:4]
    np.testing.assert_allclose(r.sdev, ref_s / np.sqrt(X_np.shape[0] - 1),
                               rtol=1e-3)
    np.testing.assert_allclose(r.center, X_np.mean(0), rtol=1e-3, atol=1e-3)
    scores = fm.as_np(r.scores)
    ref_scores = Xc @ r.rotation
    sign = np.sign((scores * ref_scores).sum(0))
    np.testing.assert_allclose(scores * sign, ref_scores * sign,
                               rtol=1e-2, atol=1e-2)
    j = jalg.pca(jfm.conv_R2FM(X_np, host=host), k=4)
    np.testing.assert_allclose(r.sdev, j.sdev, rtol=1e-4)
    # moment pass + sweep/Gram pass, then the scores pass and its rescale
    assert fm.exec_stats()["passes"] == 4


def test_pca_scaled_matches_correlation_eigs(X_np, backend):
    r = pca(fm.conv_R2FM(X_np), k=10, scale=True)
    evals = np.sort(np.linalg.eigvalsh(np.corrcoef(X_np.T)))[::-1]
    np.testing.assert_allclose(np.sort(r.sdev ** 2)[::-1], evals,
                               rtol=2e-2, atol=1e-3)


def test_nmf_reconstructs(backend, host=False):
    rng = np.random.default_rng(23)
    W0 = np.abs(rng.normal(size=(1500, 4))).astype(np.float32)
    H0 = np.abs(rng.normal(size=(4, 9))).astype(np.float32)
    Xn = (W0 @ H0).astype(np.float32)
    res = nmf(fm.conv_R2FM(Xn, host=host), k=4, max_iter=60, seed=3)
    t = np.array(res.objective_trace)
    assert (np.diff(t) <= 1e-3 * np.maximum(np.abs(t[:-1]), 1.0)).all()
    rel = res.objective / float((Xn.astype(np.float64) ** 2).sum())
    assert rel < 0.01, f"relative reconstruction error {rel}"
    recon = fm.as_np(res.W).astype(np.float64) @ res.H
    direct = float(((Xn - recon) ** 2).sum())
    assert direct <= res.objective_trace[-1] * 1.5 + 1e-6
    j = jalg.nmf(jfm.conv_R2FM(Xn, host=host), k=4, max_iter=5, seed=3)
    r5 = nmf(fm.conv_R2FM(Xn, host=host), k=4, max_iter=5, seed=3)
    np.testing.assert_allclose(r5.objective_trace, j.objective_trace,
                               rtol=1e-3)
    np.testing.assert_allclose(r5.H, j.H, rtol=1e-3, atol=1e-5)


def test_gmm_loglik_monotone(blobs, backend, host=False):
    pts, _ = blobs
    res = gmm(fm.conv_R2FM(pts, host=host), k=5, max_iter=6, seed=1)
    t = np.array(res.loglik_trace)
    assert (np.diff(t) > -1e-2 * np.abs(t[:-1])).all()
    np.testing.assert_allclose(res.weights.sum(), 1.0, rtol=1e-6)
    j = jalg.gmm(jfm.conv_R2FM(pts, host=host), k=5, max_iter=6, seed=1)
    np.testing.assert_allclose(res.loglik_trace, j.loglik_trace, rtol=1e-4)
    np.testing.assert_allclose(res.means, j.means, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def nb_data(blobs):
    pts, _ = blobs
    labels = np.repeat(np.arange(5), 400).astype(np.float32)
    perm = np.random.default_rng(29).permutation(len(pts))
    return pts[perm], labels[perm]


def test_gaussian_nb_matches_numpy(nb_data, backend, host=False):
    Xn, yn = nb_data
    model = naive_bayes(fm.conv_R2FM(Xn, host=host),
                        fm.conv_R2FM(yn, host=host), 5)
    for j in range(5):
        sel = Xn[yn == j].astype(np.float64)
        np.testing.assert_allclose(model.means[j], sel.mean(0), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(model.variances[j], sel.var(0),
                                   rtol=1e-3, atol=1e-3)
    pred = fm.as_np(nb_predict(model, fm.conv_R2FM(Xn))).reshape(-1)
    assert (pred == yn.astype(np.int32)).mean() > 0.95
    jm = jalg.naive_bayes(jfm.conv_R2FM(Xn, host=host),
                          jfm.conv_R2FM(yn, host=host), 5)
    # var = s2/n − mu² cancels (blob means ≈ 12, variances ≈ 1): the two
    # packages' f32 sums taken in other orders agree to the reference
    # test's own variance tolerance.
    np.testing.assert_allclose(model.means, jm.means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(model.variances, jm.variances, rtol=1e-3,
                               atol=1e-3)
    jp = jfm.as_np(jalg.nb_predict(jm, jfm.conv_R2FM(Xn))).reshape(-1)
    np.testing.assert_array_equal(pred, jp)


def test_multinomial_nb(backend):
    rng = np.random.default_rng(5)
    k, p, n_per = 3, 12, 500
    probs = rng.dirichlet(np.ones(p) * 0.3, size=k)
    X = np.concatenate([rng.multinomial(40, probs[j], size=n_per)
                        for j in range(k)]).astype(np.int32)
    y = np.repeat(np.arange(k), n_per).astype(np.int32)
    model = naive_bayes(fm.conv_R2FM(X), fm.conv_R2FM(y), k,
                        kind="multinomial")
    counts = np.stack([X[y == j].sum(0) for j in range(k)]) + 1.0
    expected = np.log(counts / counts.sum(1, keepdims=True))
    np.testing.assert_allclose(model.feature_log_prob, expected, rtol=1e-5)
    pred = fm.as_np(nb_predict(model, fm.conv_R2FM(X))).reshape(-1)
    assert (pred == y).mean() > 0.9
    jm = jalg.naive_bayes(jfm.conv_R2FM(X), jfm.conv_R2FM(y), k,
                          kind="multinomial")
    np.testing.assert_allclose(model.feature_log_prob, jm.feature_log_prob,
                               rtol=1e-5)


#: The reference's tests that take ``host`` (tests/test_algorithms.py),
#: with their other parameters.
_HOST_CELLS = [
    (test_summary, {}),
    (test_correlation, {"two_pass": False}),
    (test_correlation, {"two_pass": True}),
    (test_svd, {}),
    (test_kmeans_recovers_blobs, {}),
    (test_gmm_loglik_monotone, {}),
    (test_glm_logistic_matches_numpy_irls, {}),
    (test_pca_matches_numpy, {}),
    (test_nmf_reconstructs, {}),
    (test_gaussian_nb_matches_numpy, {}),
]


@pytest.mark.parametrize(
    "test,kw", _HOST_CELLS,
    ids=[t.__name__ + "".join(f"-{k}={v}" for k, v in kw.items())
         for t, kw in _HOST_CELLS])
def test_host_tier_cells(test, kw, backend, request):
    """The reference's ``host=True`` cells: the test's inputs in host RAM
    in both packages, run as the reference runs them."""
    args = {name: request.getfixturevalue(name)
            for name in inspect.signature(test).parameters
            if name not in ("backend", "host", *kw)}
    test(backend=backend, host=True, **args, **kw)


_COUNTERS = ("materialize_calls", "passes", "partition_steps", "streams",
             "bytes_streamed", "stage_bytes_read", "prefetch_reuse_hits",
             "epilogue_launches", "epilogue_host_inputs")

#: One call of each algorithm the reference runs from host RAM, as
#: ``(name, call(algorithms, fm, X, y))``.
_HOST_RUNS = [
    ("summary", lambda a, fm, X, y: a.summary(X)),
    ("correlation", lambda a, fm, X, y: a.correlation(X)),
    ("svd_tall", lambda a, fm, X, y: a.svd_tall(X, k=3, compute_u=True)),
    ("pca", lambda a, fm, X, y: a.pca(X, k=3, compute_scores=True)),
    ("kmeans", lambda a, fm, X, y: a.kmeans(X, k=3, max_iter=4, seed=1)),
    ("gmm", lambda a, fm, X, y: a.gmm(X, k=3, max_iter=3, seed=1)),
    ("glm", lambda a, fm, X, y: a.glm(X, y, family="logistic",
                                      max_iter=4)),
    ("nmf", lambda a, fm, X, y: a.nmf(fm.abs_(X), k=3, max_iter=3,
                                      seed=1)),
    ("naive_bayes", lambda a, fm, X, y: a.naive_bayes(X, y, 2)),
]


@pytest.mark.parametrize("name,run", _HOST_RUNS,
                         ids=[n for n, _ in _HOST_RUNS])
def test_host_tier_counters_equal_the_reference(name, run):
    """Each algorithm from host RAM, many 4 KiB partitions a pass: the
    port's plan counters (passes, partition steps, streams, bytes streamed
    and read from the host, resident-partition reuse, epilogues) equal the
    reference's exactly."""
    rng = np.random.default_rng(4)
    Xn = (rng.normal(size=(1200, 5)) + 1).astype(np.float32)
    yn = (rng.uniform(size=1200) < 0.5).astype(np.float32)
    got = []
    with both_conf(io_partition_bytes=4096):
        for side, alg in ((REF, jalg), (PORT, talg)):
            X = side.fm.conv_R2FM(Xn, host=True)
            y = side.fm.conv_R2FM(yn, host=True)
            with counting(side, _COUNTERS) as c:
                run(alg, side.fm, X, y)
            got.append(c)
    assert got[0]["partition_steps"] > got[0]["passes"]  # many partitions
    assert got[1] == got[0], f"port {got[1]}, reference {got[0]}"


# ---------------------------------------------------------------------------
# The disk tier (tests/test_algorithms.py's disk cells)
# ---------------------------------------------------------------------------

def test_glm_logistic_ooc_disk_one_pass_and_wgram_dispatch(
        logit_data, backend, data_dirs):
    """Logistic GLM on an ooc disk matrix matches the numpy IRLS within
    1e-5 and the reference's disk run; one streaming pass over X and y per
    iteration (each staged once a partition, however many leaves read
    them); the weighted-gram segment lowers onto the cuda wgram kernel."""
    X, y = logit_data
    Xd = fm.load_dense_matrix(X, "glm_x")
    yd = fm.load_dense_matrix(y, "glm_y")
    assert Xd.m.on_disk and yd.m.on_disk
    plan = glm_iteration_plan(Xd, yd, np.zeros(X.shape[1]), "logistic")
    assert len(plan.source_groups) == 2
    assert plan.bytes_in() == Xd.m.nbytes() + yd.m.nbytes()
    kernels = sorted(u.kernel for u in plan.program("cuda").kernel_units)
    assert "wgram" in kernels, plan.program("cuda").describe()
    res = glm(Xd, yd, family="logistic")
    np.testing.assert_allclose(res.beta, _numpy_irls_logistic(X, y),
                               rtol=1e-5, atol=1e-6)
    r = jalg.glm(jfm.load_dense_matrix(X, "glm_x"),
                 jfm.load_dense_matrix(y, "glm_y"), family="logistic")
    np.testing.assert_allclose(res.beta, r.beta, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.loglik, r.loglik, rtol=1e-6)


def test_nmf_disk_spill(data_dirs):
    """save='disk': the tall factor streams write-through to the disk tier
    every iteration, each superseded spill file is reclaimed (only the
    live W's remains), and the result matches the in-memory run and the
    reference's disk run."""
    W0 = np.abs(RNG.normal(size=(1200, 3))).astype(np.float32)
    H0 = np.abs(RNG.normal(size=(3, 7))).astype(np.float32)
    Xn = (W0 @ H0).astype(np.float32)
    Xd = fm.load_dense_matrix(Xn, "nmf_x")
    with fm.conf(io_partition_bytes=1 << 13):
        r_disk = nmf(Xd, k=3, max_iter=15, seed=1, save="disk")
    assert r_disk.W.m.on_disk and r_disk.iters > 2
    spills = list((data_dirs["repro_torch"] / "spill").glob("*.fmat"))
    assert spills == [r_disk.W.m.store.path], spills
    r_mem = nmf(fm.conv_R2FM(Xn), k=3, max_iter=15, seed=1, mode="stream")
    np.testing.assert_allclose(r_disk.objective, r_mem.objective, rtol=1e-3)
    np.testing.assert_allclose(fm.as_np(r_disk.W), fm.as_np(r_mem.W),
                               rtol=1e-3, atol=1e-4)
    j = jalg.nmf(jfm.load_dense_matrix(Xn, "nmf_x"), k=3, max_iter=15,
                 seed=1, save="disk")
    np.testing.assert_allclose(r_disk.objective_trace, j.objective_trace,
                               rtol=1e-3)


@pytest.mark.parametrize("name,run", _HOST_RUNS,
                         ids=[n for n, _ in _HOST_RUNS])
def test_disk_tier_counters_equal_the_reference(name, run, data_dirs):
    """Each algorithm from ``.fmat`` files, many 4 KiB partitions a pass:
    the port's plan counters equal the reference's exactly, as from host
    RAM."""
    rng = np.random.default_rng(4)
    Xn = (rng.normal(size=(1200, 5)) + 1).astype(np.float32)
    yn = (rng.uniform(size=1200) < 0.5).astype(np.float32)
    got = []
    with both_conf(io_partition_bytes=4096):
        for side, alg in ((REF, jalg), (PORT, talg)):
            X = side.fm.load_dense_matrix(Xn, "x")
            y = side.fm.load_dense_matrix(yn, "y")
            with counting(side, _COUNTERS) as c:
                run(alg, side.fm, X, y)
            got.append(c)
    assert got[0]["partition_steps"] > got[0]["passes"]
    assert got[0]["stage_bytes_read"] > 0
    assert got[1] == got[0], f"port {got[1]}, reference {got[0]}"
