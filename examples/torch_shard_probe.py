#!/usr/bin/env python3
"""What k shard threads on one card cost in ``stream`` mode, and why.

    PYTHONPATH=src python3 examples/torch_shard_probe.py [--rows N]

The sharded executor (``repro_torch.core.materialize._run_sharded_stream``)
drives each shard of a mesh on a thread of its own, with its own CUDA
stream.  On one card a shard adds no bandwidth — each step's kernel is
bound by the card's memory — so k shards can at best match the unsharded
run; what they add is host work on k threads under one interpreter lock.
This probe times ``correlation``, ``crossprod`` and ``kmeans(max_iter=2)``
in ``stream`` mode over an N × 32 float32 matrix on the card (Friendster-32
by default), unsharded and under ``[cuda:0] × 1, 2, 4``, with the
interpreter's default thread switch interval (5 ms) and with 0.1 ms:
a thread that gets the lock back after a call that released it (a kernel
launch through ``ctypes``) waits for the running thread to hand it over,
up to one interval.  Each cell runs once warm and three times measured
(the median wall ms, host clock around a call that ends in a
synchronize), with the steps' host seconds (``device_step_seconds``,
summed over threads) and the partition steps.  One more cell, ``k=1
fresh``, runs one shard on a CUDA stream made anew for each sweep instead
of the executor's kept stream (``materialize._shard_stream``): what the
caching allocator's per-stream pools cost.  One JSON line each, then the
card's name and power limit as ``nvidia-smi`` prints them.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, "src")


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=65_608_366)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_shard_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.algorithms import correlation, kmeans
    from repro_torch.core import fm, materialize
    from repro_torch.launch.mesh import Mesh
    from repro_torch.observability import metrics
    fm.set_conf(device="cuda", backend="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2016)
    x = torch.randn((args.rows, 32), generator=gen, device="cuda")
    X = fm.conv_R2FM(x)
    calls = (
        ("correlation", lambda: correlation(X, mode="stream")),
        ("crossprod", lambda: fm.materialize(fm.crossprod(X),
                                             mode="stream")),
        ("kmeans", lambda: kmeans(X, k=10, max_iter=2, mode="stream")))
    meshes = [("unsharded", None)] + [
        (f"k={k}", Mesh([torch.device("cuda", 0)] * k, ("data",)))
        for k in (1, 2, 4)]
    meshes.insert(2, ("k=1 fresh", meshes[1][1]))
    kept = materialize._shard_stream
    default = sys.getswitchinterval()
    for interval in (default, 1e-4):
        sys.setswitchinterval(interval)
        for label, mesh in meshes:
            materialize._shard_stream = (
                (lambda dev, k: torch.cuda.Stream(dev))
                if label.endswith("fresh") else kept)
            with fm.conf(mesh=mesh if mesh is not None else False):
                for name, fn in calls:
                    fn()
                    torch.cuda.synchronize()
                    walls, steps_s, steps = [], [], 0
                    for _ in range(3):
                        st0 = fm.exec_stats()
                        s0 = metrics.root_counter("device_step_seconds")
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                        steps_s.append(
                            metrics.root_counter("device_step_seconds") - s0)
                        steps = (fm.exec_stats()["partition_steps"]
                                 - st0["partition_steps"])
                    emit({"probe": "shard", "switch_interval_s": interval,
                          "mesh": label, "call": name,
                          "wall_ms": statistics.median(walls),
                          "walls_ms": walls, "partition_steps": steps,
                          "step_host_ms": statistics.median(steps_s) * 1e3})
    sys.setswitchinterval(default)
    materialize._shard_stream = kept
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
