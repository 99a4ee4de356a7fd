#!/usr/bin/env python3
"""Read the numbers that decide ``correct``, for the program and for its
control, over many seeds in one process (the kernels load once).

    python3 flashr_bench/calibrate.py --workload friendster32-suite \
        --program-seeds 11 12 13 --control-seeds 21 22 23 --seconds 4

For each program seed: one run of the cell (``harness.execute``) with a
short window, its numbers as compared.  For each control seed: the inputs
made from the seed, and each operation of the mix answered by the control
(the plain reference at float32 with TF32 operands, ``reference.precision``;
an operation's ``control`` where it has one, else its ``reference``) in the
program's place, compared with the reference exactly as the program's
answers are.  One JSON line per seed and side on standard
output.  The lower reading of a number is the largest over the program's
seeds, the upper the smallest over the control's.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def control(workload, seed, device, bench, cfg_over=None, mix_over=None):
    """The control's worst reading of each number over one call of each
    operation of the cell's mix, on the inputs made from ``seed``."""
    import numpy as np
    import torch
    from flashr_bench import loops, manifest
    from flashr_bench.reference.precision import CONTROL, REFERENCE
    sel = manifest.cell(bench, workload)
    cfg = {**manifest.read_json(sel["config"]["file"]), **(cfg_over or {})}
    mix = {**manifest.traffic(sel["cell"]["traffic"]), **(mix_over or {})}
    gen = manifest.module("generators", cfg["kind"])
    data = gen.make(torch, cfg, seed, device)
    ref = loops.reference_inputs(data)
    worst = {}
    t0 = time.perf_counter()
    for i, spec in enumerate(mix["calls"]):
        op = manifest.module("ops", spec["op"])
        params = op.draw(spec, np.random.default_rng([seed, 0, i]), i)
        want = op.reference(ref, params, REFERENCE)
        got = getattr(op, "control", op.reference)(ref, params, CONTROL)
        for name, v in op.compare(got, want, ref, params).items():
            worst[name] = max(worst.get(name, float("-inf")), float(v))
    out = {"side": "control", "seed": seed, "checks": worst,
           "limits": mix["limits"], "seconds": time.perf_counter() - t0}
    del data, ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from flashr_bench import harness, manifest
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load()
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in args.program_seeds:
        t0 = time.perf_counter()
        out = harness.execute(args.workload, seed, args.seconds, False,
                              t_start=t0, bench=bench, log=lambda o: None)
        emit({"side": "program", "seed": seed, "correct": out["correct"],
              "attempted": out["attempted"], "failed": out["failed"],
              "checks": {k: v["value"] for k, v in out["checks"].items()},
              "metrics": out["metrics"],
              "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        emit(control(args.workload, seed, torch.device("cuda"), bench))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
