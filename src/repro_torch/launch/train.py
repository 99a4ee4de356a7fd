"""Training launcher: the end-to-end entry point — the port of
repro/launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 50 --batch 8 --seq 256 --ckpt-dir ck --resume

Config → model zoo → sharded token pipeline → train step over a (data,
model) mesh (FSDP and model-axis shardings from the logical-axis policy)
→ async atomic checkpoints → preemption guard → straggler monitor.  It
runs on ``cuda`` unless the engine's ``device`` knob asks for the CPU
(``fm.set_conf(device="cpu")``); with no card and no such request it
raises.  The mesh is ``make_host_mesh(model=--model-parallel)`` over the
distinct visible devices (one CPU, or the machine's cards: a (1, 1) mesh
on one device).  Parameters are drawn from a ``torch.Generator`` seeded 0
on the model's device, then laid out by ``tree_shardings``; the AdamW
state follows them, the batches are laid out by ``"batch|seq"``, and a
resume restores onto the mesh's shardings.  As the reference's launcher,
every step's batch carries zero float32 stand-ins for the stub frontends:
``patch_embs`` (B, n_patches, d_model) for a VLM, ``frames`` (B, enc_len,
d_model) for an enc-dec model.
"""
from __future__ import annotations

import argparse
import logging
import time

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config (smoke/examples)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    from ..checkpoint import Checkpointer
    from ..configs import get_config, reduced_for_smoke
    from ..data.pipeline import DataConfig, DataIterator
    from ..distributed import sharding as shd
    from ..models import zoo
    from ..optim import adam
    from ..runtime.fault_tolerance import PreemptionGuard, StragglerMonitor
    from .mesh import make_host_mesh
    from .steps import build_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    mesh = make_host_mesh(model=args.model_parallel)
    model = zoo.build(cfg)
    log.info("arch=%s mesh=%s params(full)=%.2fB", cfg.name,
             dict(zip(mesh.axis_names, mesh.devices.shape)),
             cfg.n_params() / 1e9)
    opt_cfg = adam.AdamConfig(lr=args.lr)

    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    p_shapes, p_axes = model.abstract_params()
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    params = shd.place_tree(model.init(gen), p_sh)
    opt_state = adam.init(params, opt_cfg)
    data_cfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                          vocab=cfg.vocab)
    rows = shd.sharding_for("batch|seq", (args.batch, args.seq), mesh)
    it = DataIterator(data_cfg, sharding={"tokens": rows, "labels": rows})
    stubs = {}
    if cfg.family == "vlm":
        stubs["patch_embs"] = (args.batch, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        stubs["frames"] = (args.batch, cfg.enc_len, cfg.d_model)
    stubs = {k: shd.place(torch.zeros(v),
                          shd.sharding_for("batch|seq|embed", v, mesh))
             for k, v in stubs.items()}

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = {"params": params, "opt": opt_state}
        state_sh = {"params": p_sh,
                    "opt": shd.tree_shardings(
                        adam.opt_state_axes(p_axes), opt_state, mesh)}
        state, start_step, extra = ckpt.restore(state, shardings=state_sh)
        params, opt_state = state["params"], state["opt"]
        it.load_state_dict(extra.get("data", {"step": start_step}))
        log.info("resumed from step %d", start_step)

    step_fn = build_train_step(model, opt_cfg)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()

    losses = []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {**next(it), **stubs}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.record(step, time.perf_counter() - t0)

            if step % args.log_every == 0 or step == args.steps - 1:
                log.info("step %5d loss %.4f gnorm %.3f (%.0f ms)", step,
                         loss, float(metrics["grad_norm"]),
                         1e3 * (time.perf_counter() - t0))
            want_ckpt = ckpt and (step + 1) % args.ckpt_every == 0
            if want_ckpt or (ckpt and guard.requested):
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"data": it.state_dict(), "loss": loss},
                          blocking=guard.requested)
            if guard.requested:
                log.warning("preempted: exiting cleanly at step %d", step + 1)
                break
    finally:
        guard.restore_handlers()
        if ckpt:
            ckpt.wait()
    dt = time.perf_counter() - t_start
    tokens = len(losses) * args.batch * args.seq
    if losses:
        log.info("done: %d steps, %.1f tok/s, loss %.4f -> %.4f",
                 len(losses), tokens / max(dt, 1e-9), losses[0], losses[-1])
    return losses


if __name__ == "__main__":
    main()
