"""The port's algorithms (summary, correlation, logistic/gaussian/poisson
GLM, k-means) on the fixtures of tests/test_algorithms.py, at that file's
tolerances, under both of the port's backends on the CPU — and against the
JAX package's own results on the same numpy inputs."""
import numpy as np
import pytest
import torch

from repro import algorithms as jalg
from repro.core import fm as jfm
from repro_torch.algorithms import (correlation, glm, glm_iteration_plan,
                                    glm_predict, kmeans, summary)
from repro_torch.algorithms.kmeans import _init_centers, kmeans_iteration
from repro_torch.core import fm
from repro_torch.kernels import kmeans_assign as ka
from repro_torch.observability import metrics

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


def test_summary(X_np, backend):
    s = summary(fm.conv_R2FM(X_np))
    np.testing.assert_allclose(s.mean, X_np.mean(0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, X_np.var(0, ddof=1), rtol=1e-2)
    np.testing.assert_allclose(s.col_min, X_np.min(0))
    np.testing.assert_allclose(s.col_max, X_np.max(0))
    np.testing.assert_allclose(s.l1, np.abs(X_np).sum(0), rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, (X_np != 0).sum(0))
    r = jalg.summary(jfm.conv_R2FM(X_np))
    for f in ("col_min", "col_max", "mean", "l1", "l2", "nnz", "var"):
        np.testing.assert_allclose(getattr(s, f), getattr(r, f), rtol=1e-5)


@pytest.mark.parametrize("two_pass", [False, True])
def test_correlation(X_np, backend, two_pass):
    c = correlation(fm.conv_R2FM(X_np), two_pass=two_pass)
    np.testing.assert_allclose(c, np.corrcoef(X_np.T), rtol=2e-2, atol=2e-3)
    r = jalg.correlation(jfm.conv_R2FM(X_np), two_pass=two_pass)
    np.testing.assert_allclose(c, r, rtol=1e-4, atol=1e-5)


def test_kmeans_recovers_blobs(blobs, backend):
    pts, centers = blobs
    res = kmeans(fm.conv_R2FM(pts), k=5, max_iter=30, seed=1)
    d = np.linalg.norm(res.centers[:, None] - centers[None], axis=-1)
    assert (d.min(1) < 1.0).all()
    assert res.wss < pts.shape[0] * 8 * 2.0
    r = jalg.kmeans(jfm.conv_R2FM(pts), k=5, max_iter=30, seed=1)
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


def test_glm_logistic_matches_numpy_irls(logit_data, backend):
    X, y = logit_data
    res = glm(fm.conv_R2FM(X), fm.conv_R2FM(y), family="logistic")
    ref = _numpy_irls_logistic(X, y)
    np.testing.assert_allclose(res.beta, ref, rtol=1e-5, atol=1e-6)
    assert res.converged
    t = np.array(res.loglik_trace)
    assert (np.diff(t) > -1e-6 * np.abs(t[:-1])).all()
    r = jalg.glm(jfm.conv_R2FM(X), jfm.conv_R2FM(y), family="logistic")
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
