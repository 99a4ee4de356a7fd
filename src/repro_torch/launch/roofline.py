"""Roofline over the dry-run's records — the twin of
repro/launch/roofline.py, on the constants of one NVIDIA H100 SXM 80GB at
its 700 W limit.  Three terms a mesh position:

    compute term    = dot FLOPs and kernel FLOPs / the peak of their type
    memory term     = HBM bytes / HBM_BW
    collective term = its copies within a node / NVLINK_BW
                      + its copies across nodes / IB_BW

Constants: 989 TFLOP/s bf16 dense on the tensor cores and 67 TFLOP/s f32
outside them (the port runs with TF32 off), 80 GB of HBM at 3.35 TB/s
(NVIDIA's H100 SXM data sheet); NVLink
900 GB/s a GPU (the H100 data sheet); one ConnectX-7 at 400 Gb/s, 50 GB/s,
a GPU (the DGX H100 data sheet).  A node holds 8 consecutive positions of
the mesh in row-major order (``hlo_analysis.NODE_POSITIONS``): a copy whose
positions all lie in one node takes NVLink, one that crosses nodes
InfiniBand.  On (16, 16) the ``model`` axis spans two nodes.

The collective term prices every kind of copy the account counts alike:
``all-gather``, ``reduce-scatter``, ``all-reduce`` (counted at the
operand's bytes a receiving position, the reference's convention),
``all-to-all`` (a tensor-parallel prefill's K/V moved into the
sequence-split cache), ``broadcast``, the cache's and the output's reads
and writes, ``all-reduce-int8``.

The records come from ``launch/dryrun.py`` (``results/dryrun/...``): an
account of the shapes on a CPU, not a measurement.  The memory term is
the reference's analytic lower bound — every argument read once, every
output written once, the temporaries written and read once — with the
kernels' own HBM bytes added.  Each term is taken at every position and
the step is bounded by the slowest position (``bound_at``); ``fits`` says
whether that position's ``peak_device_bytes`` is within 80 GB.

MODEL_FLOPS uses the 6·N·D rule (6·N_active·D for MoE), D = tokens per
step, 2·N·D for serving shapes, over the mesh's devices; 6ND/dot is how
much of the counted dot work is "useful" (remat recompute, masked
attention tiles, capacity padding and work every data row repeats push it
down).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun]
        [--emit markdown|json] [--all-meshes]
"""
from __future__ import annotations

import argparse
import json
import pathlib

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # per GPU, dense
HBM_BW = 3.35e12                                        # bytes/s per GPU
HBM_BYTES = 80e9                                        # bytes per GPU
NVLINK_BW = 900e9                                       # bytes/s per GPU
IB_BW = 50e9                                            # bytes/s per GPU

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,        # one token per sequence
    "long_500k": 1,
}


def model_flops(arch: str, shape: str, n_devices: int) -> float:
    """6·N_active·D per step (fwd+bwd); serve shapes: 2·N_active·D."""
    from ..configs import get_config
    cfg = get_config(arch)
    n = cfg.n_active_params()
    d = SHAPE_TOKENS[shape]
    mult = 6.0 if shape.startswith("train") else 2.0
    return mult * n * d / n_devices


def analytic_hbm_bytes(pos: dict) -> float:
    """A position's HBM traffic lower bound: its arguments read, its
    outputs written, its temporaries written and read once, and its
    kernels' own bytes."""
    return float(pos["argument_bytes"] + pos["output_bytes"]
                 + pos["temp_bytes"] + pos.get("kernel_bytes", 0))


def terms(pos: dict) -> dict:
    """The three terms of one position of a record, in seconds."""
    t_compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                    for dt, f in pos["dot_flops_by_dtype"].items())
    t_compute += sum(k["flops"] / PEAK_FLOPS[k["dtype"]]
                     for k in pos["kernels"].values())
    inter = pos["inter_node_bytes"]
    t_coll = ((pos["collective_bytes_total"] - inter) / NVLINK_BW
              + inter / IB_BW)
    return {"compute": t_compute, "memory": analytic_hbm_bytes(pos) / HBM_BW,
            "collective": t_coll}


def load_cells(root: pathlib.Path):
    return [json.loads(f.read_text()) for f in sorted(root.glob("*/*/*.json"))]


def derive(rec: dict) -> dict:
    arch, shape = rec["arch"], rec["shape"]
    n_dev = rec["n_devices"]
    per = [(terms(p), p) for p in rec["positions"]]
    t, at = max(per, key=lambda tp: max(tp[0].values()))
    dominant = max(t, key=t.get)
    bound = t[dominant]
    dot = rec["loop_aware"]["dot_flops"] + rec["loop_aware"]["kernel_flops"]
    mf = model_flops(arch, shape, n_dev)
    peak = rec["memory"]["peak_device_bytes"]
    return {
        "arch": arch, "shape": shape, "mesh": rec["mesh"],
        "t_compute_s": t["compute"], "t_memory_s": t["memory"],
        "t_collective_s": t["collective"], "dominant": dominant,
        "bound_at": at["pos"],
        "model_flops": mf, "dot_flops": dot,
        "useful_ratio": mf / dot if dot else float("nan"),
        "roofline_fraction": ((mf / PEAK_FLOPS["bfloat16"]) / bound
                              if bound > 0 else float("nan")),
        "mem_gib": peak / 2 ** 30, "fits": peak <= HBM_BYTES,
        "status": rec.get("status"),
    }


def markdown(rows, single_pod_only=True):
    out = ["| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | 6ND/dot | roofline frac | mem GiB | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if single_pod_only and r["mesh"] != "16x16":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {r['mem_gib']:.1f} | {'yes' if r['fits'] else 'no'} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--emit", default="markdown", choices=["markdown", "json"])
    ap.add_argument("--all-meshes", action="store_true")
    args = ap.parse_args(argv)
    cells = load_cells(pathlib.Path(args.dir))
    rows = [derive(r) for r in cells if r.get("status") == "ok"]
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    if args.emit == "json":
        print(json.dumps(rows, indent=1))
    else:
        print(markdown(rows, single_pod_only=not args.all_meshes))


if __name__ == "__main__":
    main()
