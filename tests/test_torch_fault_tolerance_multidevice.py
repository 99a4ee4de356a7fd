"""Twin of tests/test_fault_tolerance_multidevice.py: the port's fault-
tolerance paths over meshes of repeated CPU devices, held against the JAX
package where the two compute the same thing.

1. Elastic re-mesh: a checkpoint written under a (4, 2) ``Mesh`` of
   repeated CPU devices, parameters FSDP + model sharded, restores onto
   ``replan_mesh(4, prefer_model=2)`` bit for bit, each leaf laid out by
   its new sharding.
2. The int8 error-feedback reduction across a ``pod`` axis
   (``optim.compression.cross_pod_psum_int8``): the reference's inputs
   (seed 0, 4 × 256, 30 rounds) through the reference inside a jitted
   ``shard_map`` over 4 forced host devices (a subprocess: XLA's device
   count must be set before JAX starts) and through the port over
   ``[cpu] × 4``; every round's reduced values and residuals equal, and
   the reference test's unbiasedness bound on the port.
3. Preemption: ``launch.train.main`` 6 steps with a checkpoint every 2,
   then ``--resume`` to 8 runs exactly 2.
4. Sharded checkpoints across packages: a state sharded over a (4, 2)
   mesh saved by either package restores in the other onto its (4, 2)
   mesh, bit for bit, bf16 leaves included.
5. Elastic restore onto a mesh whose data rows do not divide the batch:
   reduced llama3.2-3b's training state saved over 16 positions restores
   onto ``replan_mesh(12, prefer_model=16)`` = (3, 4), and one train step
   on 8 rows (every data row computing them whole) holds to one device.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import fm
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, ShardedTensor, place
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import zoo
from repro_torch.optim import adam, compression
from repro_torch.runtime import replan_mesh, rescale_grad_accum

pytestmark = pytest.mark.slow  # subprocess multi-device runs, as the reference's

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _mesh(shape, names=("data", "model")):
    return Mesh(np.array([CPU] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


def test_elastic_remesh_restore(tmp_path):
    """Before failure: 8 positions, (4, 2), w FSDP + model sharded; after:
    4 survivors, the replanned mesh, restored resharded."""
    mesh_a = _mesh((4, 2))
    w = torch.arange(64.0 * 32).reshape(64, 32)
    sh_a = NamedSharding(mesh_a, ("data", "model"))
    tree = {"w": place(w, sh_a), "step": torch.tensor(7, dtype=torch.int32)}
    assert tree["w"].local((3, 1)).shape == (16, 16)
    ck = Checkpointer(tmp_path)
    ck.save(7, tree, blocking=True)

    mesh_b = replan_mesh(4, prefer_model=2, devices=[CPU] * 4)
    assert mesh_b.devices.size == 4 and mesh_b.devices.shape == (2, 2)
    sh_b = {"w": NamedSharding(mesh_b, ("data", "model")),
            "step": NamedSharding(mesh_b, ())}
    out, step, _ = ck.restore(tree, shardings=sh_b)
    assert step == 7
    assert out["w"].sharding == sh_b["w"] != sh_a
    assert out["w"].local((1, 1)).shape == (32, 16)
    assert torch.equal(out["w"].local((1, 1)), w[32:, 16:])
    np.testing.assert_array_equal(np.asarray(out["w"]), w.numpy())
    assert int(out["step"].full()) == 7
    assert rescale_grad_accum(2, old_data=4, new_data=2) == 4


def test_elastic_restore_onto_twelve_then_step(tmp_path):
    """Reduced llama3.2-3b's parameters and AdamW state (float32 moments)
    saved over (4, 4) positions; 4 of 16 hosts lost: restored onto
    ``replan_mesh(12, prefer_model=16)`` = (3, 4), where 8 rows do not
    split over the 3 data rows.  One train step there against the same
    step on one device: the loss and the gradient norm within 1e-5
    relative; each leaf's first and second moments — (1 - b1) × its
    gradient and (1 - b2) × its square — within 1e-5 of their largest
    entry; and each parameter's entries whose first moment is above 1e-4
    of its largest within 1e-6 of the parameter's largest entry (a step
    moves an entry by about ``lr``, 3e-4, so a step of the wrong size or
    sign shows).  AdamW's first step divides each gradient entry by its
    size, so an entry whose gradient is near 0 may move by up to ``lr``
    on the least difference: the rest of a leaf is held only to that,
    and the moments carry the check there."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              grad_accum=1)
    model = zoo.build(cfg, "cpu")
    opt_cfg = adam.AdamConfig(moment_dtype="float32")
    shapes, axes = model.abstract_params()
    sp = shd.place_tree(model.init(0), shd.tree_shardings(
        axes, shapes, _mesh((4, 4))))
    state = {"params": sp, "opt": adam.init(sp, opt_cfg)}
    ck = Checkpointer(tmp_path)
    ck.save(3, state, blocking=True)

    mesh = replan_mesh(12, prefer_model=16, devices=[CPU] * 12)
    assert mesh.devices.shape == (3, 4)
    sh = {"params": shd.tree_shardings(axes, shapes, mesh),
          "opt": shd.tree_shardings(adam.opt_state_axes(axes),
                                    state["opt"], mesh)}
    got, step, _ = ck.restore(state, shardings=sh)
    assert step == 3
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 24))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    train_step = steps.build_train_step(model, opt_cfg)
    before = {k: v.full().clone() for k, v in zoo.flatten(got["params"])}
    p2, o2, m2 = train_step(got["params"], got["opt"], batch)
    p1 = model.init(0)
    p1, o1, m1 = train_step(p1, adam.init(p1, opt_cfg), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k])), k
    for mom in ("m", "v"):
        for (name, a), (_, b) in zip(zoo.flatten(o1[mom]),
                                     zoo.flatten(o2[mom])):
            if a.numel():
                err = (b.full().double() - a.double()).abs().max()
                assert float(err) <= 1e-5 * float(a.double().abs().max()), \
                    (mom, name)
    m1 = dict(zoo.flatten(o1["m"]))
    for (name, a), (_, b) in zip(zoo.flatten(p1), zoo.flatten(p2)):
        if a.numel():
            b = b.full()
            assert not torch.equal(b, before[name]), name
            diff = (b.double() - a.detach().double()).abs()
            assert float(diff.max()) <= opt_cfg.lr, name
            m = m1[name].double().abs()
            sure = m > 1e-4 * m.max()
            assert float(diff[sure].max()) <= \
                1e-6 * float(a.detach().double().abs().max()), name


_INT8 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # jax < 0.6 keeps it under experimental
        from jax.experimental.shard_map import shard_map
    from repro.optim import compression
    from repro.launch.mesh import mesh_axis_kwargs

    mesh = jax.make_mesh((4,), ("pod",), **mesh_axis_kwargs(1))
    rng = np.random.default_rng(0)
    g_all = jnp.asarray(rng.normal(size=(4, 256)) * 1e-3, jnp.float32)

    def body(g, e):
        reduced, new_err = compression.cross_pod_psum_int8(
            {"w": g[0]}, {"w": e[0]}, axis_name="pod")
        return reduced["w"][None], new_err["w"][None]

    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P("pod", None), P("pod", None)),
                           out_specs=(P("pod", None), P("pod", None))))
    err = jnp.zeros((4, 256), jnp.bfloat16)
    rounds = []
    for _ in range(30):
        red, err = fn(g_all, err)
        rounds.append({"red": np.asarray(red).tolist(),
                       "err": np.asarray(err, np.float32).tolist()})
    print(json.dumps(rounds))
""")


def test_int8_crosspod_gradient_reduction():
    """Each of the 30 rounds equal to the reference's (reduced values and
    bf16 residuals, every pod position), and the mean within the reference
    test's bound of the exact sum."""
    ref = _run(_INT8)
    rng = np.random.default_rng(0)
    g_all = (rng.normal(size=(4, 256)) * 1e-3).astype(np.float32)
    sh = NamedSharding(_mesh((4,), ("pod",)), ("pod", None))
    grads = {"w": place(torch.from_numpy(g_all), sh)}
    err = compression.init_error_state(grads)
    assert err["w"].sharding == sh and err["w"].dtype == torch.bfloat16
    exact = g_all.sum(0)
    total = np.zeros(256)
    for want in ref:
        red, err = compression.cross_pod_psum_int8(grads, err,
                                                   axis_name="pod")
        assert isinstance(red["w"], ShardedTensor)
        np.testing.assert_array_equal(red["w"].numpy(),
                                      np.asarray(want["red"], np.float32))
        np.testing.assert_array_equal(err["w"].numpy(),
                                      np.asarray(want["err"], np.float32))
        total += red["w"].local((0,))[0].numpy()
    np.testing.assert_allclose(total / 30, exact, rtol=0.05, atol=2e-5)


def test_preemption_checkpoint_loss_bounded(tmp_path):
    """Preempt mid-training (simulated), resume: at most one step lost."""
    ck = str(tmp_path / "ck")
    with fm.conf(device="cpu"):
        losses = train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                             "6", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", ck, "--ckpt-every", "2",
                             "--log-every", "100"])
        more = train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                           "8", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", ck, "--resume",
                           "--log-every", "100"])
    assert len(losses) == 6 and all(map(np.isfinite, losses))
    assert len(more) == 2, f"resume should run exactly steps 6..7: {len(more)}"


_JSTATE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import numpy as np, jax, jax.numpy as jnp, ml_dtypes
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import Checkpointer
    from repro.launch.mesh import make_host_mesh

    mode, path = sys.argv[1], sys.argv[2]
    mesh = make_host_mesh(8, model=2)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    m = rng.normal(size=(64, 32)).astype(ml_dtypes.bfloat16)
    sh = {"params": {"w": NamedSharding(mesh, P("data", "model"))},
          "opt": {"m": NamedSharding(mesh, P("data", None)),
                  "step": NamedSharding(mesh, P())}}
    ck = Checkpointer(path)
    if mode == "save":
        tree = {"params": {"w": jax.device_put(w, sh["params"]["w"])},
                "opt": {"m": jax.device_put(m, sh["opt"]["m"]),
                        "step": jnp.asarray(5, jnp.int32)}}
        ck.save(5, tree, blocking=True)
        print(json.dumps({"ok": True}))
    else:
        tmpl = {"params": {"w": jnp.zeros((64, 32))},
                "opt": {"m": jnp.zeros((64, 32), jnp.bfloat16),
                        "step": jnp.asarray(0, jnp.int32)}}
        out, step, _ = ck.restore(tmpl, shardings=sh)
        print(json.dumps({
            "step": step,
            "sharded": [out["params"]["w"].sharding == sh["params"]["w"],
                        out["opt"]["m"].sharding == sh["opt"]["m"]],
            "m_dtype": str(out["opt"]["m"].dtype),
            "w_equal": bool((np.asarray(out["params"]["w"]) == w).all()),
            "m_equal": bool((np.asarray(out["opt"]["m"]).astype(np.float32)
                             == m.astype(np.float32)).all()),
            "opt_step": int(out["opt"]["step"])}))
""")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_checkpoint_across_packages(tmp_path, writer):
    """A (4, 2)-sharded state — f32 parameters FSDP + model sharded, bf16
    moments, a replicated step — saved by one package restores in the
    other onto its own (4, 2) mesh with the same specs, bit for bit."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    m = rng.normal(size=(64, 32)).astype(ml_dtypes.bfloat16)
    mesh = _mesh((4, 2))
    sh = {"params": {"w": NamedSharding(mesh, ("data", "model"))},
          "opt": {"m": NamedSharding(mesh, ("data", None)),
                  "step": NamedSharding(mesh, ())}}
    def code(mode):
        return (f"import sys; sys.argv = ['x', '{mode}', r'{tmp_path}']\n"
                + _JSTATE)
    ck = Checkpointer(tmp_path)
    if writer == "reference":
        assert _run(code("save")) == {"ok": True}
        tmpl = {"params": {"w": torch.zeros(64, 32)},
                "opt": {"m": torch.zeros(64, 32),
                        "step": torch.tensor(0, dtype=torch.int32)}}
        out, step, _ = ck.restore(tmpl, shardings=sh)
        assert step == 5
        assert out["params"]["w"].sharding == sh["params"]["w"]
        assert out["opt"]["m"].sharding == sh["opt"]["m"]
        assert out["opt"]["m"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["params"]["w"].numpy(), w)
        np.testing.assert_array_equal(out["opt"]["m"].numpy(),
                                      m.astype(np.float32))
        assert int(out["opt"]["step"].full()) == 5
    else:
        mb = torch.from_numpy(m.view(np.int16).copy()).view(torch.bfloat16)
        tree = {"params": {"w": place(torch.from_numpy(w),
                                      sh["params"]["w"])},
                "opt": {"m": place(mb, sh["opt"]["m"]),
                        "step": place(torch.tensor(5, dtype=torch.int32),
                                      sh["opt"]["step"])}}
        ck.save(5, tree, blocking=True)
        got = _run(code("restore"))
        assert got == {"step": 5, "sharded": [True, True],
                       "m_dtype": "bfloat16", "w_equal": True,
                       "m_equal": True, "opt_step": 5}, got
