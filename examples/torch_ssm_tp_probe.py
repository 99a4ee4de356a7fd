#!/usr/bin/env python3
"""The float32 noise floor of an SSM or hybrid step at full width, beside
its tensor-parallel step's distance from the unsharded one.

    PYTHONPATH=src python3 examples/torch_ssm_tp_probe.py \
        [--arch zamba2-7b] [--layers 7] [--tokens 520] [--batch 4]

chip_smoke.py's path s holds the train step over (data 2, model 2)
positions of one card (``models.tensor_parallel_ssm``) to the unsharded
one.  Two float32 computations of one function differ by their rounding,
amplified by the function's conditioning; this probe measures how far
equally valid one-device computations of the same step fall from each
other, so the tensor-parallel step's distance can be read against it.
From one seed (the config at full width, ``--layers`` deep, float32
weights and activations, ``--batch`` × ``--tokens`` tokens) it computes
the loss and gradients

* ``one``: ``steps.loss_and_grads`` on one device (s3's reference);
* ``accum2``: the same batch as two microbatches (``grad_accum`` 2): the
  same gradient, its sums in another order;
* ``tiles``: ``ssm.TILE_BYTES`` at 1/16 of its value, so the SSD scan runs
  its chunks in smaller blocks (other batched-matmul shapes);
* ``tp``: ``steps.sharded_loss_and_grads`` over (data 2, model 2);

and prints, for each of the last three against ``one``, the loss's
relative difference and every gradient leaf's largest difference relative
to its largest entry.  Then the serving steps: one device's prefill and
two greedy decode steps on the whole batch against each half of the batch
served alone (the other batch shape, ``tp_serve_f32_arm``'s reference),
their largest logit and cache differences.  One JSON line each, then the
card's name and power limit as ``nvidia-smi`` prints them.  Needs a CUDA
card (``--device cpu`` runs it small on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

sys.path.insert(0, "src")


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    if not b.numel():
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def grads(steps, zoo, model, params, batch):
    loss, _, g = steps.loss_and_grads(model, params, batch)
    out = {k: v.detach().clone() for k, v in zoo.flatten(g)}
    for _, p in zoo.flatten(params):
        p.grad = None
        p.requires_grad_(False)
    return float(loss), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--tokens", type=int, default=520)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2035)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import ssm, zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = args.device
    cfg = get_config(args.arch)
    if dev == "cpu":
        cfg = reduced_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, n_layers=args.layers, dtype="float32",
                              param_dtype="float32", grad_accum=1)
    model = zoo.build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    B, S = args.batch, args.tokens
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    base = {"arch": args.arch, "layers": args.layers, "tokens": S,
            "batch": B, "seed": args.seed}

    l1, g1 = grads(steps, zoo, model, params, batch)
    runs = {}
    m2 = zoo.build(dataclasses.replace(cfg, grad_accum=2), dev)
    runs["accum2"] = grads(steps, zoo, m2, params, batch)
    tile = ssm.TILE_BYTES
    ssm.TILE_BYTES = tile // 16
    try:
        runs["tiles"] = grads(steps, zoo, model, params, batch)
    finally:
        ssm.TILE_BYTES = tile
    mesh = Mesh(np.array([torch.device(dev, 0) if dev == "cuda" else
                          torch.device(dev)] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    shapes, axes = model.abstract_params()
    sp = shd.place_tree(params, shd.tree_shardings(axes, shapes, mesh))
    ls, _, gs = steps.sharded_loss_and_grads(model, sp, batch)
    runs["tp"] = (float(ls), {k: v.full(dev) for k, v in zoo.flatten(gs)})
    del sp, gs
    for name, (loss, g) in runs.items():
        errs = {k: rel(v, g1[k]) for k, v in g.items()}
        print(json.dumps({**base, "against": "one", "run": name,
                          "loss_rel": abs(loss - l1) / abs(l1),
                          "grad_rel_err_max": max(errs.values()),
                          "grad_worst_leaf": max(errs, key=errs.get),
                          "grad_rel_err_by_leaf": errs}), flush=True)

    pre = steps.build_prefill_step(model, S + 2)
    dec = steps.build_decode_step(model)

    def serve(rows):
        cache, lg = pre(params, {"tokens": toks[rows, :S]})
        outs = [lg]
        for i in range(2):
            cache, lg = dec(params, cache, toks[rows, i:i + 1].contiguous())
            outs.append(lg)
        return outs, {k: v.clone() for k, v in zoo.flatten(cache)}
    whole, wc = serve(slice(0, B))
    dev_logits, dev_cache = 0.0, 0.0
    for r in (slice(0, B // 2), slice(B // 2, B)):
        outs, c = serve(r)
        dev_logits = max(dev_logits, max(rel(a, b[r]) for a, b in
                                         zip(outs, whole)))
        dev_cache = max(dev_cache, max(
            rel(v, wc[k].narrow(_bdim(k), r.start, r.stop - r.start))
            for k, v in c.items() if k != "len"))
    print(json.dumps({**base, "serving": "whole batch against its halves "
                      "alone", "logits_rel_dev": dev_logits,
                      "cache_rel_dev": dev_cache}), flush=True)
    if dev == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0


def _bdim(name: str) -> int:
    """The batch dim of a stacked cache leaf: after its layer axes."""
    return {"ssm.conv": 1, "ssm.state": 1, "ssm_groups.conv": 2,
            "ssm_groups.state": 2, "ssm_tail.conv": 1, "ssm_tail.state": 1,
            "kv.k": 1, "kv.v": 1}[name]


if __name__ == "__main__":
    sys.exit(main())
