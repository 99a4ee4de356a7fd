"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them: the same numpy inputs, the same tolerances
(f32 1e-4, bf16 2e-2, exact k-means labels).  The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrix as jmatrix
from repro.kernels import ops
from repro_torch.core import fm, matrix
from repro_torch.kernels import (common, fused_apply_agg as faa,
                                 gram as gram_mod, kmeans_assign as ka,
                                 weighted_gram as wg)
from repro_torch.observability import metrics

RNG = np.random.default_rng(3)

ROWS = [8, 100, 1000]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    with fm.conf(device="cpu"):
        metrics.REGISTRY.reset()
        yield
        metrics.REGISTRY.reset()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(a, dtype):
    """The same values as a jax array and a torch CPU tensor."""
    a32 = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(
            torch.bfloat16)
    return jnp.asarray(a32), torch.from_numpy(a32.copy())


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [4, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    g = gram_mod.gram(xt)
    assert g.dtype == torch.float32 and g.shape == (p, p)
    np.testing.assert_allclose(g.numpy(), np.asarray(ops.gram(
        xj, block_rows=128)), **_tol(dtype))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [4, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgram_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    w = RNG.uniform(size=(n,)).astype(np.float32)
    g = wg.wgram(xt, torch.from_numpy(w).reshape(-1, 1))
    np.testing.assert_allclose(g.numpy(), np.asarray(ops.wgram(
        xj, jnp.asarray(w), block_rows=64)), **_tol(dtype))


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("p", [1, 7, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_summary_matches_pallas(n, p, dtype):
    xj, xt = _pair(RNG.normal(size=(n, p)), dtype)
    outs = faa.fused_summary(xt)
    refs = ops.fused_summary(xj, block_rows=64)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(_np(o).astype(np.float32),
                                   np.asarray(r, np.float32), **_tol(dtype))


_CHAIN_CASES = {
    # int32 source, exact int32 accumulators
    "int_acc": (np.int32, (((), "sum", "int32"), (("sq",), "sum", "int32"),
                           (("abs", "neg"), "min", "int32"),
                           ((), "max", "int32"), ((), "count", "int32"),
                           ((), "count_nonzero", "int32"))),
    # lazy casts inside the chain, int and float accumulators
    "casts": (np.int32, ((("cast_float32", "sqrt"), "sum", "float32"),
                         (("cast_float32", "sq"), "max", "float32"),
                         (("cast_bfloat16", "sq"), "sum", "float32"),
                         (("abs", "sqrt", "cast_int32"), "sum", "int32"))),
    # every float unary once
    "unaries": (np.float32, tuple(((u,), "sum") for u in (
        "identity", "abs", "sq", "exp", "neg", "sigmoid", "floor", "ceil",
        "round", "sign", "cast_float32", "cast_bfloat16"))),
    "domain": (np.float32, ((("abs", "sqrt"), "sum"), (("abs", "log1p"),
                                                       "max"),
                            (("abs", "exp", "log"), "min"))),
}


@pytest.mark.parametrize("case", sorted(_CHAIN_CASES))
@pytest.mark.parametrize("n", [37, 1000])
def test_fused_apply_agg_chains_match_pallas(case, n):
    dt, chains = _CHAIN_CASES[case]
    a = (RNG.normal(size=(n, 5)) * 20).astype(dt)
    outs = faa.fused_apply_agg(torch.from_numpy(a.copy()), chains)
    refs = ops.fused_apply_agg(jnp.asarray(a), chains, block_rows=64)
    for chain, o, r in zip(faa.normalize_chains(chains), outs, refs):
        assert str(o.dtype).endswith(chain[2])
        if chain[2] == "int32":
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("src", ["nan", "all_negative"])
def test_fused_apply_agg_min_max_edges_match_pallas(src):
    a = -RNG.uniform(1.0, 2.0, size=(300, 4)).astype(np.float32)
    if src == "nan":
        a[7, 2] = np.nan
    chains = (((), "min"), ((), "max"), (("abs",), "max"), ((), "sum"))
    outs = faa.fused_apply_agg(torch.from_numpy(a.copy()), chains)
    refs = ops.fused_apply_agg(jnp.asarray(a), chains, block_rows=64)
    for (_, agg), o, r in zip(chains, outs, refs):
        if agg == "sum":
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", ROWS + [513])
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kmeans_assign_matches_pallas(n, k, dtype):
    xj, xt = _pair(RNG.normal(size=(n, 8)), dtype)
    cj, ct = _pair(RNG.normal(size=(k, 8)), dtype)
    lab, sums, cnts, wss = ka.kmeans_assign(xt, ct)
    rl, rs, rc, rw = ops.kmeans_assign(xj, cj, block_rows=64)
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(rl))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), **_tol(dtype))
    np.testing.assert_allclose(cnts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(wss.numpy(), np.asarray(rw),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-3)


@pytest.mark.parametrize("n,p,dtype,live", [(10, 4, np.float32, 2),
                                            (100000, 12, np.float32, 3),
                                            (5000, 7, np.int32, 2),
                                            (3, 1, np.float32, 2)])
def test_block_rows_and_padding_match_reference(n, p, dtype, live):
    """The plan IR's partition rows (``block_rows``) follow the reference's
    power-of-two rule, so plans, signatures and counters match.  The port
    keeps one copy of the rule; its kernels mask a ragged edge instead of
    padding X, which the ``*_matches_pallas`` tests cover at n = 100, 1000."""
    tdt = torch.float32 if dtype == np.float32 else torch.int32
    for budget in (None, 64 * p, 1 << 20):
        assert matrix.proc_partition_rows(p, tdt, live, budget) == \
            jmatrix.proc_partition_rows(p, dtype, live, budget)
        assert matrix.io_partition_rows(p, tdt, live, budget) == \
            jmatrix.io_partition_rows(p, dtype, live, budget)
    assert matrix.proc_partition_rows(p, tdt, live) <= \
        matrix.io_partition_rows(p, tdt, live)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted, and a CUDA tensor is the only way to the kernel."""
    before = (gram_mod.launches, wg.launches, faa.launches, ka.launches)
    x = torch.randn(64, 4)
    gram_mod.gram(x)
    wg.wgram(x, torch.rand(64))
    faa.fused_summary(x)
    ka.kmeans_assign(x, x[:3])
    assert (gram_mod.launches, wg.launches, faa.launches,
            ka.launches) == before


def test_wrappers_validate_inputs():
    with pytest.raises(TypeError):
        gram_mod.gram(torch.zeros(8, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        wg.wgram(torch.zeros(8, 2), torch.zeros(7))
    with pytest.raises(ValueError):
        faa.fused_apply_agg(torch.zeros(8, 2), (((), "median"),))
    with pytest.raises(ValueError):
        faa.fused_apply_agg(torch.zeros(8, 2), ((("tanh",), "sum"),))
    with pytest.raises(ValueError):
        ka.kmeans_assign(torch.zeros(8, 2), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        common.route(torch.zeros(2), torch.zeros(2, device="meta"))


def test_chain_program_encodes_type_changes():
    """The int program the kernel reads: opcodes and the value type entering
    each step (0 int, 1 f32, 2 bf16) follow the reference chain's casts;
    the source type the kernel reads uses the same codes."""
    prog = faa.encode(((("sq", "sqrt", "cast_int32", "cast_bfloat16"),
                        "max", "int32"),), torch.int32)
    assert prog[:2] == [1, 0]
    assert faa.encode(((("sq",), "sum", "int32"),),
                      torch.bfloat16)[:4] == [1, 2, 1, 2]
    assert faa.encode(((("sq",), "sum", "float32"),),
                      torch.float32)[:4] == [1, 1, 1, 1]
    nsteps, start, agg, acc_int = prog[2:6]
    ops_ = prog[6:6 + 16][:nsteps]
    types = prog[6 + 16:6 + 32][:nsteps]
    assert (nsteps, start, agg, acc_int) == (4, 0, 2, 1)
    assert [faa.CHAIN_UNARIES[o] for o in ops_] == [
        "sq", "sqrt", "cast_int32", "cast_bfloat16"]
    assert types == [0, 0, 1, 0]
