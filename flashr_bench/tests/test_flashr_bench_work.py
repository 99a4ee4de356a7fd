"""Work counted from the algorithm against hand counts, and traffic that
repeats exactly by seed."""
import numpy as np
import pytest
import torch

from flashr_bench_tiny import CELL, SEED

from flashr_bench import loops, manifest  # noqa: E402  (after the path set-up)


def loop_bytes(cell):
    sel = manifest.cell(manifest.load(), cell)
    cfg = manifest.read_json(sel["config"]["file"])
    mix = manifest.traffic(sel["cell"]["traffic"])
    sizes = manifest.module("generators", cfg["kind"]).input_bytes(cfg)
    total = 0
    for i, spec in enumerate(mix["calls"]):
        op = manifest.module("ops", spec["op"])
        total += op.work(cfg, sizes,
                         op.draw(spec, np.random.default_rng(i), i))["bytes"]
    return total


def test_dense_suite_counts_15_passes_of_x_and_8_of_y():
    """glm's 8 and kmeans' 5 passes over all of X, summary's and
    correlation's over all rows of X but 4,096, and glm's 8 over y."""
    x, y = 65_608_366 * 32 * 4, 65_608_366 * 4
    assert x == 8_397_870_848
    assert loop_bytes(CELL) == 15 * x + 8 * y - 2 * 4096 * 32 * 4
    assert round(loop_bytes(CELL) / 1e9, 2) == 128.07


@pytest.mark.parametrize("kind", ["dense_logistic"])
def test_inputs_repeat_by_seed(kind):
    gen = manifest.module("generators", kind)
    cfg = {"rows": 3000, "cols": 5, "beta_low": -0.5, "beta_high": 0.5}
    dev = torch.device("cpu")
    a, b = gen.make(torch, cfg, SEED, dev), gen.make(torch, cfg, SEED, dev)
    c = gen.make(torch, cfg, SEED + 1, dev)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_closed_calls_repeat_by_seed_and_differ_between_calls():
    mix = manifest.traffic("suite")
    ops = {c["op"]: manifest.module("ops", c["op"]) for c in mix["calls"]}
    one = loops.Closed(mix, ops, {}, {}, SEED)
    two = loops.Closed(mix, ops, {}, {}, SEED)
    glm = next(c for c in mix["calls"] if c["op"] == "glm")
    km = next(c for c in mix["calls"] if c["op"] == "kmeans")
    assert one._params(glm, (0, 2), 0) == two._params(glm, (0, 2), 0)
    assert one._params(glm, (0, 2), 0) != one._params(glm, (0, 6), 1)
    assert one._params(km, (0, 3), 0) != one._params(km, (0, 7), 1)


@pytest.mark.parametrize("op", ["summary", "correlation"])
def test_a_window_of_rows_is_never_read_twice_in_a_run(op):
    """Each call of summary and correlation reads its own window of X's
    rows: the warm call's and the window's first 4,096 calls' all differ,
    and all have the same shape."""
    mix = manifest.traffic("suite")
    spec = next(c for c in mix["calls"] if c["op"] == op)
    mod = manifest.module("ops", op)
    loop = loops.Closed(mix, {op: mod}, {}, {}, SEED)
    ordinals = [loop.base - 1] + [loop.base + j for j in range(4096)]
    offsets = [loop._params(spec, (0, j), o)["offset"]
               for j, o in enumerate(ordinals)]
    assert len(set(offsets)) == len(offsets)
    assert 0 <= min(offsets) and max(offsets) <= spec["cut_rows"]
    x = torch.arange(10_000).reshape(-1, 1)
    from flashr_bench.ops._common import window
    shapes = {tuple(window(x, {"offset": s, "cut_rows": spec["cut_rows"]})
                    .shape) for s in offsets}
    assert shapes == {(10_000 - spec["cut_rows"], 1)}


def test_trace_reduction_unions_busy_time_and_names_idle_gaps():
    from flashr_bench.tracing import reduce
    events = [("k1", "kernel", 1.0, 2.0), ("k2", "kernel", 1.5, 3.0),
              ("copy", "gpu_memcpy", 5.0, 6.0), ("k1", "kernel", 9.0, 12.0)]

    def span_at(t):
        return "glm" if 3.0 <= t <= 7.0 else "between_calls"
    r = reduce(events, 0.5, 10.0, span_at)
    assert r["window_s"] == 9.5
    assert r["busy_s"] == 2.0 + 1.0 + 1.0
    assert r["kernel_s"] == 1.0 + 1.5 + 1.0 and r["kernels"] == 3
    assert r["device_ops"][0] == ["k1", 2.0]
    assert dict(r["idle_gaps"]) == {"glm": 2.0, "between_calls": 0.5 + 3.0}
    assert reduce(events, 20.0, 30.0, span_at) is None
