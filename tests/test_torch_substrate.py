"""Twin of tests/test_substrate.py: the port's checkpoints, token pipeline,
optimizer and fault runtime, each test the reference's on the port, and
the cells that hold the port to the reference: checkpoints written by
each package restored by the other (bf16 leaves included) and equal byte
for byte, and token windows equal to the reference's bit for bit.

Cells still owed to ROADMAP A14 (they need the LM half of the sharding
policy): ``replan_mesh`` (here it raises naming A14), the elastic restore
onto new shardings (``test_elastic_restore_resharded``; the cross-package
restore stands in its place) and gradient compression
(``test_compression_error_feedback_unbiased``).
"""
import json
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data import DataConfig as JDataConfig
from repro.data import DataIterator as JDataIterator
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, DataIterator, TokenSource
from repro_torch.optim import adam, schedule
from repro_torch.runtime import (StragglerMonitor, StepTimer, replan_mesh,
                                 rescale_grad_accum)


# -- checkpoint ---------------------------------------------------------------

def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(3, tree, extra={"data": {"step": 3}}, blocking=True)
    out, step, extra = ck.restore(tree)
    assert step == 3 and extra["data"]["step"] == 3
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.device == b.device


def test_checkpoint_atomic_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    steps = sorted(ck.all_steps())
    assert steps == [3, 4]          # gc kept the last two
    assert ck.latest_step() == 4
    # a stale .tmp dir must not be visible as a checkpoint
    (tmp_path / "step_0000000099.tmp").mkdir()
    assert ck.latest_step() == 4


def test_checkpoint_corruption_detected(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), blocking=True)
    d = next((pathlib.Path(tmp_path)).glob("step_*/leaf_00000.npy"))
    d.write_bytes(b"corrupt!" + d.read_bytes()[8:])
    with pytest.raises(IOError):
        ck.restore(_tree())


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(5, tree, blocking=False)
    tree["w"].add_(1.0)            # the host copy was taken in save
    ck.wait()
    assert ck.latest_step() == 5
    out, _, _ = ck.restore(_tree())
    assert torch.equal(out["w"], torch.arange(12.0).reshape(3, 4))


def _jtree():
    return {"w": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.ones((5,), jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    """The same tree saved by each package: the same files, the same
    bytes, the same manifest."""
    Checkpointer(tmp_path / "port").save(2, _tree(), extra={"x": 1},
                                         blocking=True)
    JCheckpointer(tmp_path / "ref").save(2, _jtree(), extra={"x": 1},
                                         blocking=True)
    a, b = (tmp_path / d / "step_0000000002" for d in ("port", "ref"))
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    assert json.loads((a / "manifest.json").read_text())["leaves"][
        "nested/b"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restored_across_packages(tmp_path, writer):
    """In place of the elastic resharded restore: a checkpoint of the
    other package restored, bf16 leaves included, each leaf in the
    template's dtype (an f32 template over a bf16 leaf casts)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)
    if writer == "port":
        Checkpointer(tmp_path).save(4, {
            "w": torch.from_numpy(w),
            "m": {"b": torch.from_numpy(b.astype(np.float32)).bfloat16()},
            "step": torch.tensor(4, dtype=torch.int32)},
            extra={"data": {"step": 4}}, blocking=True)
        out, step, extra = JCheckpointer(tmp_path).restore(
            {"w": jnp.zeros((4, 6)), "m": {"b": jnp.zeros(7, jnp.bfloat16)},
             "step": jnp.asarray(0, jnp.int32)})
        assert out["m"]["b"].dtype == jnp.bfloat16
        got_b = np.asarray(out["m"]["b"]).astype(np.float32)
        got_w, got_step = np.asarray(out["w"]), int(out["step"])
    else:
        JCheckpointer(tmp_path).save(4, {
            "w": jnp.asarray(w), "m": {"b": jnp.asarray(b)},
            "step": jnp.asarray(4, jnp.int32)},
            extra={"data": {"step": 4}}, blocking=True)
        out, step, extra = Checkpointer(tmp_path).restore(
            {"w": torch.zeros(4, 6), "m": {"b": torch.zeros(7)},
             "step": torch.tensor(0, dtype=torch.int32)})
        assert out["m"]["b"].dtype == torch.float32
        assert out["step"].dtype == torch.int32
        got_b = out["m"]["b"].numpy()
        got_w, got_step = out["w"].numpy(), int(out["step"])
    assert step == 4 and extra == {"data": {"step": 4}} and got_step == 4
    np.testing.assert_array_equal(got_w, w)
    np.testing.assert_array_equal(got_b, b.astype(np.float32))


# -- data pipeline --------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(seq_len=32, global_batch=4, vocab=1000, seed=5)
    it1 = DataIterator(cfg, device="cpu")
    batches = [next(it1) for _ in range(5)]
    # resume from step 3
    it2 = DataIterator(cfg, device="cpu")
    it2.load_state_dict({"step": 3, "seed": 5})
    b3 = next(it2)
    assert torch.equal(batches[3]["tokens"], b3["tokens"])
    assert b3["tokens"].dtype == torch.int32


def test_data_labels_shifted():
    cfg = DataConfig(seq_len=16, global_batch=2, vocab=100, seed=1)
    b = next(DataIterator(cfg, device="cpu"))
    t, l = b["tokens"].numpy(), b["labels"].numpy()
    np.testing.assert_array_equal(t[:, 1:], l[:, :-1])


def test_data_multiprocess_disjoint():
    cfg = DataConfig(seq_len=16, global_batch=4, vocab=100, seed=1)
    a = DataIterator(cfg, process_index=0, process_count=2,
                     device="cpu")._host_batch(0)
    b = DataIterator(cfg, process_index=1, process_count=2,
                     device="cpu")._host_batch(0)
    assert not np.array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("source", ["synthetic", "shards"])
def test_data_windows_equal_the_references(tmp_path, source):
    """The same config in both packages: every batch of 40 steps (past a
    wraparound of the stream) equal bit for bit, for both processes of 2;
    from the synthetic Zipf stream and from a .npy and a raw uint16 shard."""
    kw = dict(seq_len=24, global_batch=4, vocab=3000, seed=9,
              synthetic_tokens=2000)
    if source == "shards":
        rng = np.random.default_rng(2)
        np.save(tmp_path / "a.npy", rng.integers(0, 3000, 700, np.int32))
        rng.integers(0, 3000, 900).astype(np.uint16).tofile(tmp_path / "b.u16")
        kw["shards"] = [str(tmp_path / "a.npy"), str(tmp_path / "b.u16")]
    for proc in range(2):
        mine = DataIterator(DataConfig(**kw), process_index=proc,
                            process_count=2, device="cpu")
        ref = JDataIterator(JDataConfig(**kw), process_index=proc,
                            process_count=2)
        for _ in range(40):
            a, b = next(mine), next(ref)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        assert mine.state_dict() == ref.state_dict()
    assert TokenSource(DataConfig(**kw)).total == (
        1600 if source == "shards" else 2000)


# -- optimizer -------------------------------------------------------------------

def test_adam_converges_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    cfg = adam.AdamConfig(lr=0.2, weight_decay=0.0, moment_dtype="float32",
                          grad_clip=0.0)
    state = adam.init(params, cfg)
    for _ in range(150):
        g = {"x": 2 * params["x"]}          # the gradient of Σ x²
        params, state, _ = adam.update(g, state, params, cfg)
    assert float(params["x"].abs().max()) < 1e-2


def test_adam_bf16_moments_shapes():
    params = {"w": torch.zeros((8, 8))}
    state = adam.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert adam.opt_state_axes({"w": "d_model|d_ff"})["m"]["w"] == "d_model|d_ff"


def test_grad_clip():
    params = {"x": torch.tensor([1.0])}
    cfg = adam.AdamConfig(lr=0.0, grad_clip=1.0)
    state = adam.init(params, cfg)
    _, _, m = adam.update({"x": torch.tensor([100.0])}, state, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(100.0)


def test_schedule_warmup_cosine():
    lr0 = float(schedule.warmup_cosine(torch.tensor(0), warmup=10, total=100))
    lrw = float(schedule.warmup_cosine(torch.tensor(10), warmup=10, total=100))
    lre = float(schedule.warmup_cosine(100, warmup=10, total=100))
    assert lr0 == 0.0 and lrw == pytest.approx(1.0) and lre == pytest.approx(0.1)


def test_schedule_matches_reference():
    from repro.optim import schedule as jschedule
    for s in (0, 3, 10, 57, 100, 140):
        got = schedule.warmup_cosine(torch.tensor(s), warmup=10, total=100)
        want = jschedule.warmup_cosine(jnp.asarray(s), warmup=10, total=100)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


# -- fault runtime ---------------------------------------------------------------

def test_straggler_monitor_flags():
    m = StragglerMonitor(threshold=2.0)
    for i in range(20):
        m.record(i, 0.1)
    assert m.record(20, 0.5) is True
    assert m.flagged
    timer = StepTimer(m)
    with timer:
        pass
    assert timer.step == 1 and len(m.times) == 22


def test_replan_mesh_and_accum():
    with pytest.raises(NotImplementedError, match="A14"):
        replan_mesh(1, prefer_model=16)
    assert rescale_grad_accum(4, old_data=16, new_data=8) == 8
    assert rescale_grad_accum(1, old_data=16, new_data=16) == 1
