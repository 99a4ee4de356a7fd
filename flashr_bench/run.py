#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 flashr_bench/run.py --workload friendster32-suite --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints the result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).  Exits non-zero and prints no
result without enough CUDA cards, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]
# Kernel caches at fixed paths inside the checkout, so that only the first
# run of a checkout builds (the port's own kernels build into
# src/repro_torch/kernels/_build).
os.environ["TRITON_CACHE_DIR"] = str(REPO / ".flashr_bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / ".flashr_bench_cache"
                                         / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from flashr_bench import harness, manifest
    bench = manifest.load()
    sel = manifest.cell(bench, args.workload)
    import torch
    need = sel["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"flashr_bench: the cell needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"flashr_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
