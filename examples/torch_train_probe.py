"""Probe of the train step's per-layer parameter views on a card.

    PYTHONPATH=src python3 examples/torch_train_probe.py [--layers 28]

The train forward takes layer i's parameters from the stacked leaves
through ``transformer.train_layer`` (``_LayerSlice``: each layer's
gradient is added into its slice of ``.grad``).  This probe times the
llama3.2-3b train step (full width, ``--layers`` deep, seq 4096, global
batch 2 in 2 microbatches, remat, bf16 moments) with those views and with
plain ``stacked[i]`` views, whose ``select`` backward makes a zero tensor
the size of the whole stacked leaf per layer — in the order A B B A, one
warm and two timed steps each — and prints each arm's step ms and peak
device memory (or the out-of-memory error) as one JSON line.
"""
import argparse
import dataclasses
import json
import time

import torch


def arm(name, cfg, steps_):
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import steps
    from repro_torch.models import transformer, zoo
    from repro_torch.optim import adam
    real = transformer.train_layer
    if name == "select":
        transformer.train_layer = transformer.layer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"arm": name}
    try:
        model = zoo.build(cfg, "cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2016)
        params = model.init(gen)
        opt = adam.init(params)
        it = DataIterator(DataConfig(seq_len=4096, global_batch=2,
                                     vocab=cfg.vocab, seed=2016),
                          device="cuda")
        step = steps.build_train_step(model)
        ms = []
        for i in range(1 + steps_):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            float(met["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=ms[1:], warm_ms=ms[0], loss=float(met["loss"]),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del params, opt, step
    except torch.OutOfMemoryError as exc:
        out.update(oom=str(exc).splitlines()[0],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        transformer.train_layer = real
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=args.layers, grad_accum=2)
    for name in ("slices", "select", "select", "slices"):
        print(json.dumps(dict(arm(name, cfg, args.steps),
                              layers=args.layers)), flush=True)


if __name__ == "__main__":
    main()
