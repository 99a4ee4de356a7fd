"""Twin of tests/test_distributed.py: the port's sharding policy and its
sharded execution held against the JAX package.

In process: the reference's seven ``resolve`` cells run on the port's
``distributed.sharding.resolve`` and are checked against the reference's
answer, and ``mesh_data_axes`` / ``data_axis_size`` / ``shard_devices`` and
``fusion.shard_ranges`` against the reference's over fake meshes and a grid
of shapes (fewer partitions than shards included).

In subprocesses: the reference's mesh cells need XLA's forced host device
count, which must be set before JAX starts, so each device count runs one
subprocess that imports both packages, runs the SAME program in each — the
reference over ``make_host_mesh(ndev)`` of forced CPU devices, the port
over ``Mesh([cpu] × ndev)`` — and prints one JSON line: per cell the
counters (``shards``, ``shard_merges``, ``shard_bytes_in``, ``streams``,
``passes``, ``partition_steps``, ``bytes_streamed``, ``pass_bytes_in``,
``epilogue_launches``), the kernels the kernel backend dispatches, and the
errors the reference's test holds to its own tolerances.  The parent test
asserts the counters and kernels exactly equal and the errors within the
reference test's tolerances.  ``test_mesh_parity_grid`` is the
reference's grid for ndev 1, 2 and 8 (its batch, spill and interrupted-
shard cases included); ``test_multidevice_equivalence`` its part 1 on a
(4, 2) ``data × model`` mesh.  Part 2 (a sharded train step) and
``test_dryrun_smoke_subprocess`` wait for the LM stack (ROADMAP A14).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import fusion as jfusion
from repro.distributed import sharding as jshd
from repro_torch.core import fusion as tfusion
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.sharding import resolve
from repro_torch.launch.mesh import Mesh

pytestmark = pytest.mark.slow  # subprocess mesh runs, as the reference's

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH1 = _FakeMesh((16, 16), ("data", "model"))
MESH2 = _FakeMesh((2, 16, 16), ("pod", "data", "model"))


def _same_as_reference(axes, shape, mesh):
    spec = resolve(axes, shape, mesh)
    assert spec == tuple(jshd.resolve(axes, shape, mesh)), (axes, shape)
    return spec


def test_param_fsdp_tp():
    spec = _same_as_reference("d_model|d_ff", (8192, 29568), MESH1)
    assert spec == ("data", "model")


def test_head_divisibility_fallback():
    spec = _same_as_reference("d_model|heads", (2048, 8 * 256), MESH1)
    assert spec == ("data", "model")
    spec = _same_as_reference("batch|seq|act_heads|head_dim",
                              (16, 128, 8, 256), MESH1)
    assert spec[2] is None


def test_batch_prefers_pod_data():
    spec = _same_as_reference("batch|seq", (256, 4096), MESH2)
    assert spec[0] == ("pod", "data")


def test_batch_one_gives_axes_to_kv_seq():
    spec = _same_as_reference("batch|kv_seq|kv_heads|head_dim",
                              (1, 524288, 32, 112), MESH1)
    assert spec[0] is None
    assert spec[1] == ("data", "model")


def test_kv_seq_model_when_batch_takes_data():
    spec = _same_as_reference("batch|kv_seq|kv_heads|head_dim",
                              (128, 32768, 8, 128), MESH1)
    assert spec[0] == "data"
    assert spec[1] == "model"


def test_no_axis_used_twice():
    spec = _same_as_reference("d_ff|vocab", (29568, 152064), MESH1)
    used = [s for s in spec if s]
    assert len(set(used)) == len(used)


def test_scalar_replicated():
    assert _same_as_reference("", (), MESH1) == ()


class _DevMesh:
    """A fake mesh whose devices are labelled, so ``shard_devices``'s choice
    and order show."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape) \
            .astype(object)


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("model", "data")),
    ((8,), ("data",)),
    ((3, 5), ("x", "i")),
    ((4,), ("model",)),
    ((1, 1), ("data", "model")),
])
def test_mesh_axes_and_shard_devices(shape, names):
    """``mesh_data_axes``, ``data_axis_size`` and ``shard_devices`` equal
    the reference's, and ``rows|rep`` resolves alike."""
    mesh = _DevMesh(shape, names)
    assert tshd.mesh_data_axes(mesh) == jshd.mesh_data_axes(mesh)
    assert tshd.data_axis_size(mesh) == jshd.data_axis_size(mesh)
    assert tshd.shard_devices(mesh) == jshd.shard_devices(mesh)
    for n in (1, 64, 65608366):
        _same_as_reference("rows|rep", (n, 1), mesh)
        _same_as_reference("rep|rep", (n, 7), mesh)


def test_port_mesh_over_repeated_devices():
    """The port's ``Mesh`` takes repeated devices (as a JAX mesh built from
    an array does) and ``shard_devices`` walks the data axis."""
    cpu = torch.device("cpu")
    mesh = Mesh(np.array([cpu] * 8, dtype=object).reshape(4, 2),
                ("data", "model"))
    assert mesh.devices.shape == (4, 2)
    assert tshd.data_axis_size(mesh) == 4
    assert tshd.shard_devices(mesh) == [cpu] * 4
    with pytest.raises(ValueError):
        Mesh([cpu] * 4, ("data", "model"))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_ranges_grid(n_shards):
    """Contiguous, partition-aligned ranges equal to the reference's, over
    a grid that includes fewer partitions than shards."""
    for long_dim in (0, 1, 7, 64, 100, 512, 1000, 4097):
        for rows in (1, 8, 64, 512, 1 << 14):
            got = tfusion.shard_ranges(long_dim, rows, n_shards)
            assert got == jfusion.shard_ranges(long_dim, rows, n_shards)
            assert len(got) == n_shards
            assert got[0][0] == 0 and got[-1][1] == long_dim
            for (lo, hi), (lo2, _) in zip(got, got[1:]):
                assert hi == lo2 and lo <= hi
                assert lo % rows == 0 or lo == long_dim


# ---------------------------------------------------------------------------
# Subprocess cells: both packages under one forced host device count
# ---------------------------------------------------------------------------

_PRELUDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%d" % NDEV)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, "tests")
    import json, threading, time
    import numpy as np, jax, torch

    from repro.core import fm as jfm, materialize as jmz
    from repro.core.fusion import Plan as JPlan
    from repro.core.matrix import DenseStore as JDenseStore
    from repro.core.matrix import FMMatrix as JFMMatrix
    from repro.launch.mesh import make_host_mesh
    from repro.observability import metrics as jmetrics
    from repro import storage as jstorage
    from repro_torch.core import fm as tfm, materialize as tmz
    from repro_torch.core.fusion import Plan as TPlan
    from repro_torch.core.matrix import DenseStore as TDenseStore
    from repro_torch.core.matrix import FMMatrix as TFMMatrix
    from repro_torch.launch.mesh import Mesh
    from repro_torch.observability import metrics as tmetrics
    from repro_torch import storage as tstorage

    assert len(jax.devices()) == NDEV
    tfm.set_conf(device="cpu")

    class Side:
        def __init__(self, name, fm, mz, Plan, DenseStore, FMMatrix,
                     metrics, storage, backend, mesh):
            self.name, self.fm, self.mz, self.Plan = name, fm, mz, Plan
            self.DenseStore, self.FMMatrix = DenseStore, FMMatrix
            self.metrics, self.storage = metrics, storage
            self.backend, self.mesh = backend, mesh

    def port_mesh(shape):
        cpu = torch.device("cpu")
        devs = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            devs[idx] = cpu
        return Mesh(devs, ("data", "model"))

    COUNTERS = ("shards", "shard_merges", "streams", "passes",
                "partition_steps", "epilogue_launches")

    def snap(S):
        st = S.mz.exec_stats()
        out = {k: st[k] for k in COUNTERS}
        out["bytes_streamed"] = int(S.metrics.root_counter("bytes_streamed"))
        return out, st

    def counted(S, fn):
        before, _ = snap(S)
        res = fn()
        after, st = snap(S)
        c = {k: after[k] - before[k] for k in after}
        c["shard_bytes_in"] = list(st["shard_bytes_in"])
        c["pass_bytes_in"] = list(st["pass_bytes_in"])
        return res, c

    def kernels(S, outs):
        plan = S.Plan([o.m for o in outs if o.m.is_virtual])
        kb = "pallas" if S.name == "repro" else "cuda"
        return sorted(u.kernel for u in plan.program(kb).kernel_units)

    def err(got, want):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want))) if got.size else 0.0
""")

_GRID = _PRELUDE + textwrap.dedent("""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(512, 6)).astype(np.float32)
    CASES = ("colMeans", "colSds", "crossprod", "scale")

    def build(S, nm, X):
        return getattr(S.fm, nm)(X)

    def run_side(S):
        fm = S.fm
        rec = {}
        fm.set_conf(io_partition_bytes=2048)
        mesh = S.mesh

        def src(mk):
            X = fm.conv_R2FM(A)
            return fm.persist(X, tier="disk") if mk == "disk" else X

        base = {}
        for mode, mk in (("whole", "mem"), ("stream", "mem"), ("ooc", "disk")):
            X = src(mk)
            base[mode] = [fm.as_np(fm.materialize(build(S, nm, X), mode=mode,
                                                  backend=S.backend)[0])
                          for nm in CASES]
        rec["base"] = {mode: [v.tolist() for v in vals]
                       for mode, vals in base.items()}
        for mode, mk in (("whole", "mem"), ("stream", "mem"), ("ooc", "disk")):
            X = src(mk)
            cells = []
            for nm, want in zip(CASES, base[mode]):
                if mode == "whole":
                    fn = lambda: fm.materialize(build(S, nm, X), mode=mode,
                                                mesh=mesh, backend=S.backend)
                else:
                    def fn():
                        fm.set_conf(mesh=mesh)
                        try:
                            return fm.materialize(build(S, nm, X), mode=mode,
                                                  backend=S.backend)
                        finally:
                            fm.set_conf(mesh=False)
                (out,), c = counted(S, fn)
                have = fm.as_np(out)
                cells.append({"case": nm, "counters": c,
                              "err": err(have, want),
                              "ok": bool(np.allclose(want, have, rtol=1e-4,
                                                     atol=1e-4)),
                              "kernels": kernels(S, [build(S, nm, X)])})
            rec[mode] = cells

        fm.set_conf(mesh=mesh)
        X = fm.conv_R2FM(A)
        (g,), c = counted(S, lambda: fm.materialize(
            fm.crossprod(X), mode="stream", backend=S.backend))
        rec["solo"] = {"counters": c, "err": err(fm.as_np(g), A.T @ A),
                       "ok": bool(np.allclose(fm.as_np(g), A.T @ A,
                                              rtol=1e-4, atol=1e-3))}

        D = fm.persist(fm.conv_R2FM(A), tier="disk")
        (Sd,), c = counted(S, lambda: fm.materialize(
            fm.scale(D, save="disk"), mode="ooc", backend=S.backend))
        ref = (A - A.mean(0)) / A.std(0, ddof=1)
        rec["spill"] = {"counters": c, "err": err(fm.as_np(Sd), ref),
                        "ok": bool(np.allclose(fm.as_np(Sd), ref, rtol=1e-3,
                                               atol=1e-3)),
                        "on_disk": bool(Sd.m.on_disk)}

        X = fm.conv_R2FM(A)
        (means, (sds, ctp)), c = counted(S, lambda: fm.batch(
            fm.colMeans(X), (fm.colSds(X), fm.crossprod(X)), mode="stream",
            backend=S.backend))
        rec["batch"] = {
            "counters": c,
            "err_ctp": err(fm.as_np(ctp), A.T @ A),
            "ok": bool(np.allclose(fm.as_np(means), A.mean(0), atol=1e-4)
                       and np.allclose(fm.as_np(ctp), A.T @ A, rtol=1e-4,
                                       atol=1e-3))}

        class FlakyStore(S.DenseStore):
            def __init__(self, data, fail_after):
                super().__init__(np.asarray(data))
                self.fail_after = fail_after
                self.reads = 0
                self._lk = threading.Lock()

            def block(self, start, stop):
                with self._lk:
                    self.reads += 1
                    n = self.reads
                if n > self.fail_after:
                    raise RuntimeError("injected shard staging failure")
                return super().block(start, stop)

        n_threads0 = threading.active_count()
        Xf = S.FMMatrix(A.shape, A.dtype, store=FlakyStore(A, 2),
                        name="flaky")
        G = fm.crossprod(fm.FM(Xf) * 2.0)
        raised = False
        try:
            fm.materialize(G, mode="stream", backend=S.backend)
        except RuntimeError:
            raised = True
        deadline = time.time() + 10
        while time.time() < deadline and (
                S.storage.live_prefetchers() or
                threading.active_count() > n_threads0):
            time.sleep(0.05)
        rec["flaky"] = {
            "raised": raised, "virtual": bool(G.m.is_virtual),
            "cached": getattr(G.m, "cached_store", None) is not None,
            "live": len(S.storage.live_prefetchers()),
            "staged": len(S.storage.staged_leaks()),
            "no_thread_left": threading.active_count() <= n_threads0,
            "shard_threads": [t.name for t in threading.enumerate()
                              if t.name.startswith("fm-shard")]}
        fm.set_conf(mesh=False)
        return rec

    out = {}
    for S in (Side("repro", jfm, jmz, JPlan, JDenseStore, JFMMatrix,
                   jmetrics, jstorage, "xla", make_host_mesh(NDEV)),
              Side("repro_torch", tfm, tmz, TPlan, TDenseStore, TFMMatrix,
                   tmetrics, tstorage, "torch", port_mesh((NDEV, 1)))):
        S.fm.reset_exec_stats()
        out[S.name] = run_side(S)
    print(json.dumps(out))
""")


def _run(script: str, ndev: int) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", f"NDEV = {ndev}\n" + script],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_mesh_parity_grid(ndev):
    """Sharded materialize == unsharded across algorithms × modes under
    1/2/8 shards in both packages, with the shard accounting exact and
    equal to the reference's; a spill lands in one store, a batch shards
    its one stream, and an interrupted shard registers nothing and leaks
    no prefetcher, staged partition or shard thread."""
    got = _run(_GRID, ndev)
    ref, port = got["repro"], got["repro_torch"]
    for mode in ("whole", "stream", "ooc"):
        # the unsharded baselines agree across packages
        for r, t in zip(ref["base"][mode], port["base"][mode]):
            np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-4)
        for rc, tc in zip(ref[mode], port[mode]):
            assert tc["counters"] == rc["counters"], (mode, tc, rc)
            assert tc["kernels"] == rc["kernels"], (mode, tc, rc)
            for side in (rc, tc):
                assert side["ok"], (mode, side)
            if mode != "whole":
                sh = tc["counters"]["shards"]
                assert sh > 0 and sh % ndev == 0, (mode, tc)
    for cell in ("solo", "spill", "batch"):
        assert port[cell]["counters"] == ref[cell]["counters"], \
            (cell, port[cell], ref[cell])
    solo = port["solo"]["counters"]
    assert solo["shards"] == ndev and solo["shard_merges"] == ndev - 1
    assert len(solo["shard_bytes_in"]) == ndev
    assert sum(solo["shard_bytes_in"]) == 512 * 6 * 4
    for side in (ref, port):
        assert side["solo"]["ok"], side["solo"]
        assert side["spill"]["on_disk"] and side["spill"]["ok"]
        b = side["batch"]
        assert b["counters"]["streams"] == 1
        assert b["counters"]["shards"] == ndev
        assert b["ok"], b
    assert port["flaky"] == ref["flaky"], (port["flaky"], ref["flaky"])
    assert port["flaky"]["raised"] and port["flaky"]["virtual"]
    assert not port["flaky"]["cached"]
    assert port["flaky"]["live"] == port["flaky"]["staged"] == 0
    assert port["flaky"]["no_thread_left"]
    assert port["flaky"]["shard_threads"] == []


_EQUIV = _PRELUDE + textwrap.dedent("""
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(512, 6)).astype(np.float32)
    out = {}
    for S in (Side("repro", jfm, jmz, JPlan, JDenseStore, JFMMatrix,
                   jmetrics, jstorage, "xla", make_host_mesh(8, model=2)),
              Side("repro_torch", tfm, tmz, TPlan, TDenseStore, TFMMatrix,
                   tmetrics, tstorage, "torch", port_mesh((4, 2)))):
        X = S.fm.conv_R2FM(Xn)
        (g, s), c = counted(S, lambda: S.fm.materialize(
            S.fm.crossprod(X), S.fm.colSums(X), mesh=S.mesh,
            backend=S.backend))
        g, s = S.fm.as_np(g), S.fm.as_np(s).ravel()
        out[S.name] = {
            "counters": c,
            "kernels": kernels(S, [S.fm.crossprod(X), S.fm.colSums(X)]),
            "gram_ok": bool(np.allclose(g, Xn.T @ Xn, rtol=1e-3)),
            "sums_ok": bool(np.allclose(s, Xn.sum(0), rtol=1e-3)),
            "gram": g.tolist()}
    print(json.dumps(out))
""")


def test_multidevice_equivalence():
    """Part 1 of the reference's test: data-parallel GenOps in whole mode
    over an 8-device (4, 2) data × model mesh equal the host reference;
    the port over ``[cpu] × 8`` with the same shape shards its rows 4 ways
    (the model axis replicates) with the reference's counters."""
    got = _run(_EQUIV, 8)
    ref, port = got["repro"], got["repro_torch"]
    assert port["counters"] == ref["counters"], (port, ref)
    assert port["counters"]["shards"] == 4
    assert port["kernels"] == ref["kernels"]
    for side in (ref, port):
        assert side["gram_ok"] and side["sums_ok"]
    np.testing.assert_allclose(port["gram"], ref["gram"], rtol=1e-4,
                               atol=1e-3)
