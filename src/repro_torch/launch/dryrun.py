"""The dry-run over the production meshes — the port's twin of
repro/launch/dryrun.py.

For every (architecture × input shape × mesh) cell:

    account = steps.lower_cell(model, shape, make_production_mesh(device="meta"))

runs the cell's step on meta tensors laid out over the (16, 16) or
(2, 16, 16) mesh of repeated meta devices (the twin of the reference's 512
placeholder host devices) and records what ``launch.hlo_analysis`` counts:
each position's bytes, dot FLOPs, kernel work and collectives, the
maximum over positions and where it is taken.  Nothing is allocated and
nothing computed, so it runs on a CPU; its numbers are an account of the
shapes, not a measurement.

Outputs one JSON record per cell into
``<out>/<mesh>/<arch>/<shape>.json`` with the reference's keys where the
meaning carries over (``status``, ``memory``, ``cost.flops``,
``collectives``, ``collective_bytes_total``, ``loop_aware.dot_flops``),
``trace_s`` in place of ``lower_s`` and ``compile_s``, ``positions``, and
``model_compute``: whether the cell's family computes over ``model``
(``models.tensor_parallel``: dense, MoE, VLM, enc-dec) or only stores on
it (SSM, hybrid); the printed line says which (``model`` / ``storage``).
A failing cell is written with its error.  ``launch/roofline.py`` turns
the records into the roofline table.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: pathlib.Path, verbose: bool = True) -> dict:
    from ..configs import get_config
    from ..configs.base import SHAPES
    from ..models import zoo
    from .mesh import make_production_mesh
    from .steps import lower_cell

    from ..models import tensor_parallel
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    mesh_name = "x".join(map(str, mesh.devices.shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "n_devices": int(mesh.devices.size),
           "model_compute": cfg.family in tensor_parallel.FAMILIES,
           "status": "ok"}
    t0 = time.time()
    try:
        acc = lower_cell(zoo.build(cfg, "meta"), shape, mesh)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec.update(acc.record)
    except Exception as e:  # noqa: BLE001 - a failing cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]

    out_path = out_dir / mesh_name / arch / f"{shape_name}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    if verbose:
        mem = rec.get("memory", {}).get("peak_device_bytes", 0) / 2**30
        flops = rec.get("cost", {}).get("flops", 0)
        tp = "model" if rec["model_compute"] else "storage"
        print(f"[{rec['status']:5s}] {mesh_name:10s} {arch:20s} "
              f"{shape_name:12s} {tp:7s} trace={rec.get('trace_s', 0):6.1f}s"
              f" mem/dev={mem:7.2f}GiB flops/dev={flops:.3e}"
              f" coll={rec.get('collective_bytes_total', 0) / 2**30:8.3f}GiB",
              flush=True)
        if rec["status"] != "ok":
            print("   ", rec["error"], flush=True)
    return rec


def cells_for(arch: str):
    from ..configs import get_config
    return list(get_config(arch).shapes().keys())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the (2,16,16) mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the (16,16) mesh")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS
    out_dir = pathlib.Path(args.out)
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    elif args.single_pod:
        meshes = [False]

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    failures = 0
    for multi in meshes:
        for arch in archs:
            shapes = [args.shape] if args.shape else cells_for(arch)
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod=multi, out_dir=out_dir)
                failures += rec["status"] != "ok"
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
