#!/usr/bin/env python3
"""What a sharded train step holds on the card at its peak, beside the
dry-run's account of the same cell.

    PYTHONPATH=src python3 examples/torch_step_peak_probe.py \
        [--arch zamba2-7b] [--layers 7] [--tokens 520] [--batch 4] \
        [--mesh 2,2]

chip_smoke.py's s4 holds the account's peak (``steps.lower_cell(...,
one_device=True)``) to the card's ``max_memory_allocated`` over one train
step of (data, model) positions of one card.  This probe runs that cell
— the config at full width, ``--layers`` deep, float32, seeded weights
laid out over the positions, AdamW — once warm, then once under the
caching allocator's memory history, and replays the history to the
moment the card held the most bytes: the live blocks then (allocated,
or freed by Python and waiting on a stream's event, ``free_requested``)
summed by the first frame of the port that allocated them, the largest
first.  Beside them, the account's predicted peak and each position's.
One JSON line each, then the card's name and power limit as
``nvidia-smi`` prints them.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys

import torch

sys.path.insert(0, "src")


def _site(ev) -> str:
    """The first frame of the port's own code that allocated a block."""
    for f in ev.get("frames", []):
        name = f["filename"]
        if "repro_torch" in name:
            return f"{name.rsplit('repro_torch/', 1)[-1]}:{f['line']} " \
                   f"{f['name']}"
    return "other"


def _walk(events, stop=None):
    """Replay allocator events (up to index ``stop``): (live blocks,
    free-requested blocks, the index at which they held the most)."""
    live, pending, held, best = {}, {}, 0, (0, 0)
    for i, ev in enumerate(events[:stop]):
        act, addr = ev["action"], ev["addr"]
        if act == "alloc":
            live[addr] = ev
            held += ev["size"]
        elif act == "free_requested" and addr in live:
            pending[addr] = live.pop(addr)
        elif act == "free_completed":
            gone = pending.pop(addr, None) or live.pop(addr, None)
            held -= gone["size"] if gone else 0
        if held > best[0]:
            best = (held, i + 1)
    return live, pending, best


def replay(snap) -> dict:
    """The moment of the device trace at which the live and
    free-requested blocks held the most bytes, and those blocks by site."""
    events = snap["device_traces"][0]
    held, at = _walk(events)[2]
    live, pending, _ = _walk(events, at)
    sites, streams = collections.Counter(), collections.Counter()
    other = []
    for state, d in (("allocated", live), ("free_requested", pending)):
        for e in d.values():
            sites[(state, _site(e))] += e["size"]
            streams[str(e["stream"])] += e["size"]
            if _site(e) == "other":
                other.append(e["size"])
    ev = events[at - 1]
    return {"traced_peak_bytes": held, "peak_event": ev["action"],
            "peak_event_site": _site(ev),
            "peak_event_frames": [f"{f['filename'].rsplit('/', 1)[-1]}:"
                                  f"{f['line']} {f['name']}"
                                  for f in ev.get("frames", [])[:8]],
            "by_stream": dict(streams),
            "other_blocks": sorted(other, reverse=True)[:30],
            "by_site": [{"state": s, "site": w, "bytes": b}
                        for (s, w), b in sites.most_common(20)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--tokens", type=int, default=520)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--seed", type=int, default=2035)
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import zoo
    from repro_torch.optim import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = tuple(int(x) for x in args.mesh.split(","))
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                              dtype="float32", param_dtype="float32",
                              grad_accum=1)
    model = zoo.build(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    params = model.init(gen)
    B, S = args.batch, args.tokens
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    n = int(np.prod(shape))
    mesh = Mesh(np.array([torch.device("cuda", 0)] * n,
                         dtype=object).reshape(shape), ("data", "model"))
    p_shapes, p_axes = model.abstract_params()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    sp = shd.place_tree(params, shd.tree_shardings(p_axes, p_shapes, mesh))
    opt = adam.init(sp)
    step = steps.build_train_step(model)
    sp, opt, _ = step(sp, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=1 << 20)
    sp, opt, _ = step(sp, opt, batch)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    measured = torch.cuda.max_memory_allocated() - resident
    out = replay(snap)
    base = {"arch": args.arch, "layers": args.layers, "tokens": S,
            "batch": B, "mesh": list(shape)}
    print(json.dumps({**base, "measured_peak_bytes": measured, **out}),
          flush=True)
    del sp, opt, params
    meta = Mesh(np.array([torch.device("meta")] * n,
                         dtype=object).reshape(shape), ("data", "model"))
    rec = steps.lower_cell(zoo.build(cfg, "meta"),
                           ShapeSpec("probe", S, B, "train"), meta,
                           one_device=True).record
    print(json.dumps({**base, "account_device_peak_bytes":
                      rec["device_peak_bytes"],
                      "rel_err": rec["device_peak_bytes"] / measured - 1,
                      "position_peak_bytes": {
                          str(tuple(p["pos"])): p["peak_device_bytes"]
                          for p in rec["positions"]}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
