"""Twin of tests/test_system.py's FlashR user journey: the paper's workflow
end to end on the port, its data on the host tier the whole time, against
the reference's journey on the same numpy input — at the reference's
partition budget (one partition a pass at this size) and at a 256 KiB one,
where every pass streams out of core in about 20 partitions through the
background prefetcher in both packages.

The serving journey runs both packages' load generators with the same
arguments.  The LM training journey (``test_lm_train_checkpoint_resume``)
trains reduced qwen2-0.5b with the port's ``launch.train.main``,
checkpoints and resumes it, as the reference's test does; its checkpoint
is restored by the reference's ``Checkpointer`` into the reference's
train state, and the port's launcher resumes from a checkpoint the
reference's launcher wrote.
"""
import numpy as np
import pytest

from helpers_twin import data_dirs, time_limit  # noqa: F401
from repro import algorithms as jalg
from repro.core import fm as jfm
from repro_torch import algorithms as talg
from repro_torch import storage as tstorage
from repro_torch.core import fm as tfm

pytestmark = pytest.mark.usefixtures("time_limit")


def _journey(fm, alg, X_host, k):
    """The reference test's steps over one package; its own checks, and
    the results the packages are compared on."""
    X = fm.conv_R2FM(X_host, host=True)
    s = alg.summary(X)
    assert np.isfinite(s.mean).all() and (s.var > 0).all()
    corr = alg.correlation(X)
    assert np.allclose(np.diag(corr), 1.0, atol=1e-5)
    svd = alg.svd_tall(X, k=4)
    assert (np.diff(svd.s) <= 1e-6).all()  # descending
    res = alg.kmeans(X, k=k, max_iter=20, seed=0)
    # identical results from the in-memory tier
    corr2 = alg.correlation(fm.conv_R2FM(X_host))
    np.testing.assert_allclose(corr, corr2, rtol=1e-4, atol=1e-5)
    return s, corr, svd, res


@pytest.mark.parametrize("budget", [None, 1 << 18],
                         ids=["reference-budget", "streamed"])
def test_flashr_user_journey(budget):
    rng = np.random.default_rng(0)
    n, p, k = 40_000, 12, 4
    centers = rng.normal(size=(k, p)) * 10
    X_host = np.concatenate(
        [c + rng.normal(size=(n // k, p)) for c in centers]).astype(np.float32)

    with tfm.conf(device="cpu", io_partition_bytes=budget), \
            jfm.conf(io_partition_bytes=budget):
        tfm.reset_exec_stats()
        ts, tcorr, tsvd, tres = _journey(tfm, talg, X_host, k)
        st = tfm.exec_stats()
        js, jcorr, jsvd, jres = _journey(jfm, jalg, X_host, k)
    assert tstorage.live_prefetchers() == []
    # one partition a pass at the reference's budget, many at 256 KiB
    assert (st["partition_steps"] > st["passes"]) == bool(budget)

    d = np.linalg.norm(tres.centers[:, None] - centers[None], axis=-1)
    assert (d.min(1) < 1.0).all()
    np.testing.assert_allclose(ts.mean, js.mean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.var, js.var, rtol=1e-4)
    np.testing.assert_allclose(tcorr, jcorr, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsvd.s, jsvd.s, rtol=1e-4)
    np.testing.assert_allclose(tres.centers, jres.centers, rtol=1e-4,
                               atol=1e-4)
    assert tres.iters == jres.iters


def test_serve_loadgen_journey(data_dirs):
    """The serving journey: the load generator's serial-vs-serve arms over
    one named disk matrix — each wave's concurrent same-source requests
    share ONE streaming drive and read strictly fewer bytes — with the
    same arguments in both packages, and the same evidence."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    argv = ["--n", "6000", "--p", "4", "--clients", "3", "--waves", "2",
            "--partition-kib", "16", "--name", "system_serve_x"]
    got = {}
    for name, serve in (("repro", jserve), ("repro_torch", tserve)):
        with tfm.conf(device="cpu"):
            serial, served = serve.main(argv)
        assert served["streams"] == 2            # one stream per wave
        assert serial["streams"] == 6            # one stream per request
        assert served["bytes_per_request"] * 3 == serial["bytes_per_request"]
        assert served["requests"] == serial["requests"] == 6
        got[name] = [{k: r[k] for k in ("arm", "streams",
                                        "bytes_per_request", "requests")}
                     for r in (serial, served)]
    assert got["repro_torch"] == got["repro"]
    assert served["backend"] == "torch"


def test_lm_train_checkpoint_resume(tmp_path):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    with tfm.conf(device="cpu"):
        losses = train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                             "8", "--batch", "4", "--seq", "64", "--ckpt-dir",
                             ck, "--ckpt-every", "4", "--log-every", "100"])
        assert losses[-1] < losses[0], "loss must decrease"
        resumed = train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                              "10", "--batch", "4", "--seq", "64",
                              "--ckpt-dir", ck, "--resume", "--log-every",
                              "100"])
    assert len(resumed) == 2  # steps 8..9 only: resume picked up step 8


def test_lm_train_checkpoints_cross_packages(tmp_path):
    """The port's launcher resumes from the reference launcher's
    checkpoint (runs steps 4..5 of 6), and the reference's Checkpointer
    restores the port's step-6 checkpoint into the reference's own train
    state: the same keys, shapes and dtypes, bf16 moments included."""
    import jax
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_config, reduced_for_smoke
    from repro.launch import train as jtrain
    from repro.models import zoo as jzoo
    from repro.models.base import tree_unbox
    from repro.optim import adam as jadam
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4", "--seq",
            "32", "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "100"]
    jtrain.main(argv + ["--steps", "4"])
    with tfm.conf(device="cpu"):
        resumed = train.main(argv + ["--steps", "6", "--resume"])
    assert len(resumed) == 2 and all(np.isfinite(resumed))
    model = jzoo.build(reduced_for_smoke(get_config("qwen2-0.5b")))
    params, _ = tree_unbox(model.init(jax.random.PRNGKey(0)))
    template = {"params": params, "opt": jadam.init(params)}
    state, step, extra = JCheckpointer(ck).restore(template)
    assert step == 6 and extra["data"]["step"] == 6
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree_util.tree_leaves(template)):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert np.isfinite(np.asarray(got, np.float32)).all(), path
