"""BENCHMARK.json's checks, the files the harness finds by name, and a cell
added by new files and entries alone."""
import copy
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from flashr_bench_tiny import REPO, TINY_ROWS

from flashr_bench import manifest  # noqa: E402  (after the path set-up)


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_checks():
    manifest.check(bench())


def test_every_named_file_is_there():
    b = bench()
    for c in b["configs"]:
        cfg = manifest.read_json(c["file"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        manifest.module("generators", cfg["kind"])
    for w in b["workloads"]:
        for call in manifest.traffic(w["traffic"])["calls"]:
            manifest.module("ops", call["op"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(manifest.module("metrics", m["name"]).read)


def _broken(edit):
    b = copy.deepcopy(bench())
    edit(b)
    with pytest.raises(manifest.ManifestError):
        manifest.check(b)


@pytest.mark.parametrize("case", [
    "name_with_space", "name_with_slash", "unit_with_space", "unit_too_long",
    "moves_no_end_to_end", "cell_without_its_end_to_end", "no_setup_s",
    "extra_key", "bound_too_wide", "unknown_cell", "same_pair_twice",
    "chips_two"])
def test_a_broken_manifest_is_refused(case):
    def edit(b):
        if case == "name_with_space":
            b["per_layer"][0]["name"] = "kernels roofline"
        elif case == "name_with_slash":
            b["workloads"][0]["name"] = "a/b"
        elif case == "unit_with_space":
            b["end_to_end"][0]["unit"] = "GB per s"
        elif case == "unit_too_long":
            b["end_to_end"][0]["unit"] = "g" * 17
        elif case == "moves_no_end_to_end":
            b["per_layer"][0]["moves"] = "device_idle_pct.scan"
        elif case == "cell_without_its_end_to_end":
            b["per_layer"][0]["workloads"] = ["dummy"]
            b["workloads"].append(dict(b["workloads"][0], name="dummy",
                                       traffic="dummy"))
        elif case == "no_setup_s":
            b["end_to_end"] = [m for m in b["end_to_end"]
                               if m["name"] != "setup_s"]
        elif case == "extra_key":
            b["per_layer"][0]["why"] = "a reason"
        elif case == "bound_too_wide":
            b["end_to_end"][0]["bound"] = 0.3
        elif case == "unknown_cell":
            b["per_layer"][0]["workloads"] = ["no-such-cell"]
        elif case == "same_pair_twice":
            w = dict(b["workloads"][0], name="suite-again")
            b["workloads"].append(w)
        elif case == "chips_two":
            b["workloads"][0]["chips"] = 2
    _broken(edit)


DUMMY_CFG = {"name": "dummy_dense", "kind": "dense_logistic",
             "rows": TINY_ROWS, "cols": 8, "beta_low": -0.5,
             "beta_high": 0.5, "reduced": [], "assumed": []}
DUMMY_MIX = {"loop": "closed", "mode": "whole",
             "calls": [{"op": "summary", "cut_rows": 16},
                       {"op": "colsums_dummy"}],
             "check_each": 1,
             "limits": {"summary.exact": 0, "summary.mean": 1e-3,
                        "colsums_dummy.err": 1e-6}}
DUMMY_OP = '''"""colSums(X), a new operation."""
import numpy as np


def work(cfg, sizes, params):
    return {"bytes": sizes["X"], "flops": cfg["rows"] * cfg["cols"],
            "passes": 1}


def draw(spec, rng, ordinal):
    return {}


def call(ctx, params):
    (s,) = ctx.fm.materialize(ctx.fm.colSums(ctx.X), mode=ctx.mode)
    return {"s": np.asarray(ctx.fm.as_np(s), np.float64).reshape(-1)}


def reference(ref, params, prec):
    return {"s": ref.x.double().sum(0).cpu().numpy()}


def compare(ans, r, ref, params):
    return {"colsums_dummy.err": float(np.max(np.abs(ans["s"] - r["s"])
                                              / ref.x.shape[0]))}
'''
DUMMY_METRIC = '''"""Calls completed in the window."""


def read(run):
    return float(sum(d.ok for d in run.done))
'''


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell, each
    a new file or entry: no file that is there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "flashr_bench", root / "flashr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "flashr_bench/configs/dummy_dense.json").write_text(
        json.dumps(DUMMY_CFG))
    (root / "flashr_bench/traffic/dummy_mix.json").write_text(
        json.dumps(DUMMY_MIX))
    (root / "flashr_bench/metrics/calls_done.dummy.py").write_text(
        DUMMY_METRIC)
    (root / "flashr_bench/ops/colsums_dummy.py").write_text(DUMMY_OP)
    b = bench()
    b["configs"].append({"name": "dummy_dense", "source": "a test",
                         "file": "flashr_bench/configs/dummy_dense.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy-cell", "config": "dummy_dense",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "scan_rate":
            m["workloads"] = m["workloads"] + ["dummy-cell"]
    b["per_layer"].append({"name": "calls_done.dummy", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "scan_rate",
                           "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in (REPO / "flashr_bench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {str(REPO / 'src')!r}]
from flashr_bench import harness
for trace in (False, True):
    out = harness.execute("dummy-cell", 5, 0.3, trace,
                          t_start=time.perf_counter(), device="cpu",
                          log=lambda o: None)
    print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert plain["correct"] and traced["correct"], (plain["checks"],
                                                    traced["checks"])
    assert set(plain["metrics"]) == {"scan_rate", "setup_s"}
    assert traced["metrics"]["calls_done.dummy"]["value"] >= 2
    after = {p: p.read_bytes() for p in (REPO / "flashr_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def test_nothing_under_the_benchmark_loads_jax_or_the_jax_package():
    """Every module of flashr_bench imported in a fresh process, top-level
    names compared whole: repro_torch is allowed, repro is not."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "flashr_bench").rglob("*.py")
        if "tests" not in p.parts and "." not in p.stem
        and p.parent.name not in ("metrics",))
    code = f"""
import importlib, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
for m in {mods!r}:
    importlib.import_module(m)
from flashr_bench import manifest
b = manifest.load()
for m in b["end_to_end"] + b["per_layer"]:
    manifest.module("metrics", m["name"])
from repro_torch.core import fm
import repro_torch.algorithms
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "flashr_bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for p in (REPO / "flashr_bench/reference").glob("*.py"):
        text = p.read_text()
        assert "repro_torch" not in text and "import repro" not in text, p
