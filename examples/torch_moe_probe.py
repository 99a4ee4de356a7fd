"""Where one MoE layer's time goes on the card: qwen3-moe-30b-a3b's layer at
full width (2048 wide, 128 experts of 768, top-8, bf16 weights from a
seeded generator) through ``repro_torch.models.moe.apply_moe`` at the
serving path's prefill shape (4 × 4096 tokens, capacity 320) and decode
shape (4 × 1, dropless), each run:

* timed on the host clock around ``reps`` calls ended by a synchronize
  (``wall_ms``) and with CUDA events (``event_ms``);
* counted for host synchronizations (``torch.cuda.set_sync_debug_mode``
  warnings a call: each one makes the host wait for the card, so the
  card then waits for the host's next launches);
* traced once with ``torch.profiler``: the call's device time (its
  kernels' summed), and the device time of each ``aten`` op with its
  share of that, the largest first.

    PYTHONPATH=src python3 examples/torch_moe_probe.py [--reps 5]

Prints one JSON line a shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings

import torch


def layer(cfg, seed):
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return moe.init_moe(cfg, gen)


def count_syncs(fn) -> int:
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in got)


def profile(fn, top=12):
    """(device ms of the traced call, its largest aten ops).  The trace
    lists each op and, apart, each kernel it launched; the kernels' sum is
    the device time (summing both would count it twice)."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ops, kernels_ms = [], 0.0
    for e in p.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        if e.key.startswith("aten::"):
            ops.append((e.key, ms, e.count))
        else:
            kernels_ms += ms
    ops.sort(key=lambda r: -r[1])
    return kernels_ms, [{"op": k, "device_ms": ms, "calls": n,
                         "share": ms / kernels_ms if kernels_ms else None}
                        for k, ms, n in ops[:top]]


def run(cfg, p, B, S, reps, seed):
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def call():
        with torch.no_grad():
            return moe.apply_moe(cfg, p, x)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    torch.cuda.synchronize()
    device_total, ops = profile(call)
    return {"batch": B, "tokens": S, "capacity": moe._capacity(cfg, S),
            "wall_ms": wall, "event_ms": start.elapsed_time(stop) / reps,
            "syncs_per_call": count_syncs(call),
            "traced_device_ms": device_total, "top_ops": ops}


def main(argv=None):
    import dataclasses
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2016)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_moe_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              param_dtype="bfloat16")
    p = layer(cfg, args.seed)
    for name, (B, S) in (("prefill", (4, 4096)), ("decode", (4, 1))):
        print(json.dumps({"probe": "moe_layer", "shape": name,
                          **run(cfg, p, B, S, args.reps, args.seed + 1)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
