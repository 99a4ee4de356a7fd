"""Where one Mamba-2 layer's time goes on the card: one SSM layer of
mamba2-1.3b (d_model 2048, 64 heads of 64, state 128) and of zamba2-7b
(d_model 3584, 112 heads of 64, state 64) at full width, bf16 weights from
a seeded generator, through ``repro_torch.models.ssm`` at the serving
path's prefill shape (``apply_ssm`` over 4 × 4096 tokens) and decode shape
(``apply_ssm_decode`` of 4 × 1 tokens), each run:

* timed on the host clock around ``reps`` calls ended by a synchronize
  (``wall_ms``) and with CUDA events (``event_ms``);
* counted for host synchronizations a call;
* traced once with ``torch.profiler``: the call's device time (its
  kernels' summed) and its largest ``aten`` ops.

The prefill is also timed with the chunks run one at a time
(``ssm.TILE_BYTES`` set to one chunk's tile) against the default blocks,
in turns (blocks, one, one, blocks), on the same inputs.

    PYTHONPATH=src python3 examples/torch_ssm_probe.py [--reps 5]

Prints one JSON line a layer and shape, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch_moe_probe import count_syncs, profile


def timed(call, reps):
    """(wall ms, event ms) a call, after one warm call."""
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
    return wall, start.elapsed_time(stop) / reps


def run(cfg, B, S, reps, seed):
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    p = ssm.init_ssm(cfg, gen)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    if S > 1:
        def call():
            with torch.no_grad():
                return ssm.apply_ssm(cfg, p, x)
    else:
        cache = ssm.init_ssm_cache(cfg, B, torch.bfloat16, "cuda")

        def call():
            with torch.no_grad():
                return ssm.apply_ssm_decode(cfg, p, x, cache)
    wall, event = timed(call, reps)
    device_total, ops = profile(call)
    out = {"batch": B, "tokens": S, "wall_ms": wall, "event_ms": event,
           "syncs_per_call": count_syncs(call),
           "traced_device_ms": device_total, "top_ops": ops}
    if S > 1:
        default, one = ssm.TILE_BYTES, (B * ssm.dims(cfg)[1]
                                        * ssm.CHUNK ** 2 * 4)
        turns = []
        for tile in (default, one, one, default):
            ssm.TILE_BYTES = tile
            turns.append(timed(call, reps)[0])
        ssm.TILE_BYTES = default
        out["wall_ms_blocks_vs_one_chunk_abba"] = turns
    return out


def main(argv=None):
    import dataclasses
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2016)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssm_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
        for name, (B, S) in (("prefill", (4, 4096)), ("decode", (4, 1))):
            print(json.dumps({"probe": "ssm_layer", "arch": arch,
                              "shape": name,
                              **run(cfg, B, S, args.reps, args.seed)}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
