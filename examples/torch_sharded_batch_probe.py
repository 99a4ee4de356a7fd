#!/usr/bin/env python3
"""The sharded train step against the one-device step on batches that do
or do not split over the data rows, with and without a ``loss_mask``.

    PYTHONPATH=src python3 examples/torch_sharded_batch_probe.py \
        [--arch qwen3-moe-30b-a3b] [--seq 24]

For each case — batch rows, ``grad_accum``, a (data, model) mesh of
repeated CPU devices, a ``loss_mask`` of about 60% of the tokens, the same
with data row 0's rows of every microbatch masked out (``"row0"``), or
none — it runs ``steps.loss_and_grads`` on one device and
``steps.sharded_loss_and_grads`` over the mesh on the same reduced config
(``reduced_for_smoke``, ``model.init(0)``, numpy seed 1 for the batch) and
prints one JSON line: the loss's relative difference (its absolute
difference where one device's loss is 0, a batch masked out whole) and
the gradient leaf farthest from one device, by its largest difference
over its largest entry, or the error the sharded step raised.  The CPU
only: it measures agreement, not time.

Its default arch reads fault C9 (``ROADMAP.md`` §C, closed): under a
``loss_mask`` on data rows that split a microbatch, each row's MoE
load-balancing term took the row's share of the mask's tokens and not its
share of all tokens, which put qwen3-moe-30b-a3b's router gradient about
1e-4 of its largest entry off one device (7e-4 to 2e-3 with a row masked
out).  ``tests/test_torch_sharded_batch.py`` now holds it
(``test_grad_accum_matches_one_device``'s masked MoE cases,
``test_masked_moe_split_matches_reference``,
``test_moe_balance_term_by_token_share``).  Its other cases read, for one
arch at a time, what that file holds, so a change to the rows' weights
can be read beside its parent on any family.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import zoo

#: (rows, grad_accum, mesh shape, loss_mask: False, True or "row0")
CASES = [(8, 1, (3, 2), False), (8, 2, (3, 1), False), (12, 2, (4, 1), False),
         (8, 1, (4, 1), False), (8, 1, (4, 1), True), (8, 2, (2, 2), True),
         (8, 2, (3, 2), True), (8, 1, (4, 1), "row0"), (8, 2, (2, 2), "row0"),
         (12, 2, (3, 2), "row0")]


def row0_masked_out(mask: np.ndarray, accum: int, n_data: int) -> np.ndarray:
    """``mask`` with data row 0's rows of every microbatch set to 0: its
    block where a microbatch splits over the ``n_data`` rows, else the
    whole microbatch (every row computes it)."""
    mask = mask.copy()
    m = mask.shape[0] // accum
    span = m // n_data if m % n_data == 0 else m
    for i in range(accum):
        mask[i * m:i * m + span] = 0
    return mask


def case(arch: str, rows: int, accum: int, shape, mask: bool, seq: int):
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)),
                              grad_accum=accum)
    model = zoo.build(cfg, "cpu")
    params = model.init(0)
    rng = np.random.default_rng(1)
    text = seq - cfg.n_patches
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (rows, text))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embs"] = torch.from_numpy(rng.normal(
            size=(rows, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(rows, cfg.enc_len, cfg.d_model)).astype(np.float32))
    if mask:
        m = (rng.random((rows, text)) < 0.6).astype(np.float32)
        if mask == "row0":
            m = row0_masked_out(m, accum, shape[0])
        batch["loss_mask"] = torch.from_numpy(m)
    out = {"arch": arch, "rows": rows, "grad_accum": accum,
           "mesh": list(shape), "loss_mask": mask}
    l1, _, g1 = steps.loss_and_grads(model, params, batch)
    g1 = {k: v.detach().clone().double() for k, v in zoo.flatten(g1)}
    for _, p in zoo.flatten(params):
        p.grad = None
        p.requires_grad_(False)
    mesh = Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                         dtype=object).reshape(shape), ("data", "model"))
    shapes, axes = model.abstract_params()
    sp = shd.place_tree(params, shd.tree_shardings(axes, shapes, mesh))
    try:
        ls, _, gs = steps.sharded_loss_and_grads(model, sp, batch)
    except ValueError as exc:
        return dict(out, raised=str(exc))
    errs = {k: float((g.full().double() - g1[k]).abs().max()
                     / g1[k].abs().max().clamp_min(1e-30))
            for k, g in zoo.flatten(gs) if g.numel()}
    worst = max(errs, key=errs.get)
    diff = abs(float(ls) - float(l1))
    loss = {"loss_rel": diff / abs(float(l1))} if float(l1) else \
        {"loss_abs": diff}
    return dict(out, **loss, worst_leaf=worst, worst_rel=errs[worst])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--seq", type=int, default=24)
    args = ap.parse_args(argv)
    for rows, accum, shape, mask in CASES:
        print(json.dumps(case(args.arch, rows, accum, shape, mask,
                              args.seq)), flush=True)


if __name__ == "__main__":
    main()
