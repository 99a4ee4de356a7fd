"""The port's dry-run tools on the CPU: ``launch.mesh.make_production_mesh``,
the families' ``cache_axes`` and ``Model.abstract_cache`` against the JAX
package's, the account of a step traced on meta tensors
(``launch.hlo_analysis``, ``steps.lower_cell``) — its first-row shortcut
against a trace of every row and microbatch, the kernel wrappers' meta
route — ``launch.roofline`` on the H100's constants, and ``launch.dryrun``
run as a program, which imports neither ``jax`` nor ``repro``.

The twin of the reference's ``test_dryrun_smoke_subprocess`` and the
specs' twins are in tests/test_torch_distributed.py beside the tests they
mirror.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import zoo as jzoo
from repro_torch.configs import ARCH_IDS, get_config, reduced_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis, roofline, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    return env


def test_make_production_mesh_matches_reference():
    """(16, 16) over ("data", "model") and (2, 16, 16) over ("pod",
    "data", "model"), as the reference builds them over 512 forced host
    devices; the port's over one repeated device."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        import json
        from repro.launch.mesh import make_production_mesh
        out = {}
        for multi in (False, True):
            m = make_production_mesh(multi_pod=multi)
            out[str(multi)] = [list(m.devices.shape), list(m.axis_names)]
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        assert [list(mesh.devices.shape), list(mesh.axis_names)] == \
            want[str(multi)]
        assert {str(d) for d in mesh.devices.flat} == {"meta"}
    with pytest.raises(TypeError):
        make_production_mesh()                        # no default device


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_abstract_cache_match_reference(arch):
    """``Model.cache_axes`` equals the reference's axes tree and
    ``abstract_cache`` its ``eval_shape`` of ``init_cache`` leaf by leaf
    (shape and dtype), as meta tensors: nothing allocated."""
    import jax
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm = jzoo.build(jcfg)

    def flat(tree):
        return {".".join(str(k.key) for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    model = zoo.build(cfg, "cpu")
    got = dict(zoo.flatten(model.abstract_cache(4, 256)))
    want = flat(jm.abstract_cache(4, 256))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k
    assert dict(zoo.flatten(model.cache_axes())) == flat(jm.cache_axes())


def _meta_mesh(shape, names=("data", "model")):
    return Mesh(np.array([torch.device("meta")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


def _records_agree(a, b, temp_slack):
    """Positions of two records: FLOPs, kernels, collectives and bytes in
    and out equal, temporaries within ``temp_slack`` bytes."""
    assert len(a["positions"]) == len(b["positions"])
    for p, q in zip(a["positions"], b["positions"]):
        assert p["pos"] == q["pos"]
        for k in ("dot_flops_by_dtype", "kernels", "collectives",
                  "argument_bytes", "output_bytes", "inter_node_bytes"):
            assert p[k] == q[k], (p["pos"], k, p[k], q[k])
        assert abs(p["temp_bytes"] - q["temp_bytes"]) <= temp_slack, \
            (p["pos"], p["temp_bytes"], q["temp_bytes"])


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-3b", "train"), ("llama3.2-3b", "prefill"),
    ("llama3.2-3b", "decode"), ("qwen3-moe-30b-a3b", "train"),
    ("mamba2-1.3b", "train"), ("whisper-medium", "train")])
def test_first_row_shortcut_equals_every_row(arch, kind):
    """``lower_cell``'s default — row 0 and one microbatch traced, scaled
    by ``grad_accum`` and given to every data row's position — equals a
    trace of every row and every microbatch on a (4, 2) meta mesh
    (reduced configs, ``grad_accum`` 2, batch 8): each position's dot
    FLOPs by dtype, kernel work, collectives by kind (bytes, counts and
    inter-node bytes) and argument and output bytes exactly; its
    temporaries within 256 bytes — what only the full trace allocates:
    the running loss of the later microbatches (a 0-d f32 a microbatch)
    and the rows' sums of a MoE layer's first-choice shares
    (``Row.gather_sum``: 4 rows × 8 experts × 4 bytes).  The full trace's
    four row threads switch every microsecond, so an update of the
    account's shared totals lost between threads would show."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              grad_accum=2)
    model = zoo.build(cfg, "meta")
    shape = ShapeSpec("t", 64, 8, kind)
    mesh = _meta_mesh((4, 2))
    short = steps.lower_cell(model, shape, mesh).record
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        full = steps.lower_cell(model, shape, mesh, every_row=True).record
    finally:
        sys.setswitchinterval(interval)
    assert short["rows_traced"]["rows"] == 1
    assert full["rows_traced"]["rows"] == 4
    assert short["loop_aware"]["dot_flops"] > 0
    _records_agree(short, full, temp_slack=256)


def test_account_counts_layout_and_positions():
    """Reduced llama3.2-3b's train cell (batch 8 × 64, ``grad_accum`` 2) on
    a (4, 2) meta mesh: every position's argument bytes are the blocks of
    the parameters, moments and batch its specs give it, its output bytes
    one gradient block of each of its parameter blocks, every position
    computes its ``model`` share (the same dot FLOPs on each), and the
    record names where each maximum is taken."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("llama3.2-3b")),
                              grad_accum=2)
    model = zoo.build(cfg, "meta")
    mesh = _meta_mesh((4, 2))
    shape = ShapeSpec("t", 64, 8, "train")
    rec = steps.lower_cell(model, shape, mesh).record
    _, sp, _ = steps.cell_specs(model, shape, mesh)
    args = {}
    for (name, t), (_, sh) in zip(
            zoo.flatten({"p": sp["args"][0], "o": sp["args"][1],
                         "b": sp["args"][2]}),
            zoo.flatten({"p": sp["in_shardings"][0],
                         "o": sp["in_shardings"][1],
                         "b": sp["in_shardings"][2]})):
        nb = int(np.prod(sh.shard_shape(tuple(t.shape)))) * t.dtype.itemsize
        for pos in sh.positions():
            args[pos] = args.get(pos, 0) + nb
    outs = {}
    for (_, t), (_, sh) in zip(zoo.flatten(sp["args"][0]),
                               zoo.flatten(sp["in_shardings"][0])):
        nb = int(np.prod(sh.shard_shape(tuple(t.shape)))) * t.dtype.itemsize
        for pos in sh.positions():
            outs[pos] = outs.get(pos, 0) + nb
    for p in rec["positions"]:
        pos = tuple(p["pos"])
        assert p["argument_bytes"] == args[pos], pos
        assert p["output_bytes"] == outs[pos], pos
        assert p["peak_device_bytes"] == (p["argument_bytes"]
                                          + p["output_bytes"]
                                          + p["temp_bytes"])
        assert p["dot_flops"] == rec["positions"][0]["dot_flops"] > 0, pos
        assert p["temp_bytes"] > 0, pos
    assert tuple(rec["max_at"]["dot_flops"]) in set(np.ndindex(4, 2))
    assert rec["memory"]["alias_bytes"] == 0
    assert set(rec["collectives"]) >= {"all-gather", "reduce-scatter"}


def test_kernel_meta_route():
    """The flash wrapper on meta tensors raises without an account; under
    one it returns an empty meta output of q's shape and reports the
    FLOPs and bytes of the tiles its kernel visits, launching nothing; a
    CPU tensor still takes the plain version, also under an account."""
    q = torch.empty(2, 4, 256, 64, device="meta")
    k = torch.empty(2, 2, 256, 64, device="meta")
    with pytest.raises(ValueError, match="outside an account"):
        ops.attention(q, k, k, causal=True)
    acc = hlo_analysis.Account(_meta_mesh((1, 1)))
    before = fa.launches
    with acc:
        out = ops.attention(q, k, k, causal=True)
        out16 = ops.attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                              k.to(torch.bfloat16), causal=False)
        rng = np.random.default_rng(0)
        qc, kc = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((1, 2, 16, 16), (1, 1, 16, 16)))
        got = ops.attention(qc, kc, kc, causal=True)
    assert fa.launches == before
    assert out.device.type == "meta" and out.shape == q.shape
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(got, ops.attention(qc, kc, kc, impl="ref"),
                               rtol=0, atol=0)
    kern = acc.slots[0].kernels["flash_attention"]
    assert kern["launches"] == 2
    # f32: the FMA body's 64 × 64 tiles, causal: q tile i reads i + 1 kv
    # tiles; bf16 at head dim 64: the wgmma body's 128 × 128 tiles, all of
    # them, P·V twice.
    f32_pairs = sum(64 * 64 * (i + 1) for i in range(4))
    bf16_pairs = 256 * 256
    assert fa.tile_work(8, 256, 256, 64, torch.float32, True)[0] == \
        8 * f32_pairs * 4 * 64
    assert kern["flops"] == 8 * f32_pairs * 4 * 64 + 8 * bf16_pairs * 6 * 64
    assert kern["bytes"] == (8 * (2 * 256 * 64 + 2 * 640 * 64) * 4
                             + 8 * (2 * 256 * 64 + 2 * 512 * 64) * 2)
    with pytest.raises(ValueError, match="outside an account"):
        ops.attention(q, k, k)                       # the account is closed
    assert common.METER is None


def test_roofline_derive_on_the_h100_constants():
    """``derive`` on a record: each position's compute term is its bf16
    work over 989 TFLOP/s plus its f32 work over 67, its memory term its
    bytes over 3.35 TB/s, its collective term its copies within a node
    over 900 GB/s plus those across nodes over 50 GB/s; the slowest
    position bounds the step and names the dominant term; ``fits`` holds
    its peak to 80 GB."""
    def pos(p, flops16, flops32, nbytes, coll, inter):
        return {"pos": p, "argument_bytes": nbytes, "output_bytes": 0,
                "temp_bytes": 0, "kernel_bytes": 0,
                "peak_device_bytes": nbytes,
                "dot_flops_by_dtype": {"bfloat16": flops16,
                                       "float32": flops32},
                "dot_flops": flops16 + flops32,
                "kernels": {"flash_attention": {"flops": 989e9,
                                                "bytes": 0.0, "launches": 1,
                                                "dtype": "bfloat16"}},
                "kernel_flops": 989e9,
                "collective_bytes_total": coll, "inter_node_bytes": inter}
    positions = [pos([0, 0], 989e12 / 2, 67e12 / 2, 3.35e9, 900e9, 0),
                 pos([0, 1], 0.0, 0.0, 90e9, 950e9, 50e9)]
    rec = {"arch": "llama3.2-3b", "shape": "decode_32k", "mesh": "16x16",
           "n_devices": 256, "status": "ok", "positions": positions,
           "memory": {"peak_device_bytes": 90e9},
           "loop_aware": {"dot_flops": (989e12 + 67e12) / 2,
                          "kernel_flops": 989e9}}
    row = roofline.derive(rec)
    assert row["bound_at"] == [0, 1]
    assert row["t_collective_s"] == pytest.approx(2.0)
    assert row["t_memory_s"] == pytest.approx(90e9 / 3.35e12)
    assert row["t_compute_s"] == pytest.approx(1e-3)
    assert row["dominant"] == "collective"
    assert row["fits"] is False
    t0 = roofline.terms(positions[0])
    assert t0["compute"] == pytest.approx(1.0 + 1e-3)
    assert t0["collective"] == pytest.approx(1.0)
    assert t0["memory"] == pytest.approx(1e-3)
    table = roofline.markdown([row])
    assert "| llama3.2-3b | decode_32k | 16x16 |" in table
    assert table.splitlines()[2].endswith("| no |")


def test_dryrun_cli_imports_neither_jax_nor_repro(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    train_4k`` (the (16, 16) mesh alone, ``--single-pod``) writes an ``ok``
    record with the reference's keys and each position's figures, and
    the process imports neither ``jax`` nor ``repro``."""
    code = textwrap.dedent(f"""
        import json, runpy, sys
        sys.argv = ["dryrun", "--arch", "llama3.2-3b", "--shape", "train_4k",
                    "--single-pod", "--out", {str(tmp_path)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        except SystemExit as e:
            code = e.code
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps({{"exit": code, "bad": bad}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"exit": 0, "bad": []}
    rec = json.loads((tmp_path / "16x16" / "llama3.2-3b" /
                      "train_4k.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for k in ("memory", "cost", "collectives", "collective_bytes_total",
              "loop_aware", "trace_s", "positions", "rows_traced"):
        assert k in rec, k
    assert len(rec["positions"]) == 256
    assert rec["loop_aware"]["dot_flops"] > 0
    row = roofline.derive(rec)
    assert row["fits"] is True             # each position its model share


def test_account_counts_the_int8_round_over_pod():
    """``optim.compression.cross_pod_psum_int8`` over a ``pod`` axis of 4
    meta positions under an account: each non-root position's int8
    payload to the group's first position (1 byte an entry) and the
    reduced f32 value back (4 bytes an entry), as ``all-reduce-int8``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim import compression
    mesh = _meta_mesh((4,), ("pod",))
    rep = shd.NamedSharding(mesh, ())
    shards = np.empty((4,), dtype=object)
    for i in range(4):
        shards[i] = torch.empty(16, device="meta")
    grads = {"w": shd.ShardedTensor(shards, rep, (16,), torch.float32)}
    err = compression.init_error_state(grads)
    acc = hlo_analysis.Account(mesh)
    with acc:
        red, _ = compression.cross_pod_psum_int8(grads, err, "pod")
    moved = sorted((nb, srcs[0], dst) for kind, nb, _, srcs, dst, _ in
                   acc.events if kind == "all-reduce-int8" and srcs[0] != dst)
    assert moved == sorted([(16, (i,), (0,)) for i in (1, 2, 3)]
                           + [(64, (0,), (i,)) for i in (1, 2, 3)])
    assert red["w"].local((3,)).shape == (16,)
