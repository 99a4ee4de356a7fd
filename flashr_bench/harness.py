"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``."""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import sys
import time

import numpy as np

from flashr_bench import loops, manifest
from flashr_bench.reference.precision import REFERENCE

#: Top-level module names no process that prints a result may hold: JAX,
#: its libraries, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    cfg: dict
    mix: dict
    seconds: float
    setup_s: float
    window_s: float
    done: list
    counted: dict
    counters: dict
    trace: dict | None


def counters(fm) -> dict:
    """The program's always-on root counters (histograms as their
    totals and counts)."""
    from repro_torch.observability import metrics
    out = {}
    for k, v in metrics.REGISTRY.root.stats().items():
        if isinstance(v, (int, float)):
            out[k] = float(v)
        elif isinstance(v, dict) and "total" in v:
            out[k + ".total"] = float(v["total"])
            out[k + ".count"] = float(v["count"])
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    may be capped below its 700 W)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_start: float, device: str = "cuda", bench: dict | None = None,
            cfg_over: dict | None = None, mix_over: dict | None = None,
            log=None) -> dict:
    """Run ``workload`` once and return the result line's object (with the
    numbers compared last).  ``cfg_over`` / ``mix_over`` replace keys of the
    configuration and the traffic mix (the CPU tests run tiny sizes)."""
    log = log or (lambda obj: print(json.dumps(obj), file=sys.stderr,
                                    flush=True))
    bench = bench or manifest.load()
    sel = manifest.cell(bench, workload)
    cfg = {**manifest.read_json(sel["config"]["file"]), **(cfg_over or {})}
    mix = {**manifest.traffic(sel["cell"]["traffic"]), **(mix_over or {})}

    import torch
    from repro_torch.core import fm
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # The configurations state float32 with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with fm.conf(device=device):
            return _window_and_checks(torch, fm, torch.device(device), sel,
                                      cfg, mix, workload, seed, seconds,
                                      trace, t_start, log)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _window_and_checks(torch, fm, dev, sel, cfg, mix, workload, seed,
                       seconds, trace, t_start, log) -> dict:
    gen = manifest.module("generators", cfg["kind"])
    sizes = gen.input_bytes(cfg)
    ops = {n: manifest.module("ops", n)
           for n in dict.fromkeys(c["op"] for c in mix["calls"])}
    loop = loops.LOOPS[mix["loop"]](mix, ops, cfg, sizes, seed)

    if dev.type == "cuda":
        log({"phase": "card", "nvidia_smi": card_line()})
    data = gen.make(torch, cfg, seed, dev)
    prog = loops.place(fm, torch, data, mix, dev)
    gc.collect()
    loop.warm(prog)
    loops.sync(torch, dev)
    setup_s = time.perf_counter() - t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = counters(fm)
    tracer = None
    if trace:
        from flashr_bench.tracing import DeviceTrace
        tracer = DeviceTrace(torch)
        with tracer:
            t0, t1 = loop.run(prog, seconds)
    else:
        t0, t1 = loop.run(prog, seconds)
    loops.sync(torch, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    after = counters(fm)
    delta = {k: after[k] - before.get(k, 0.0) for k in after}

    done = loop.done
    ok = [d for d in done if d.ok]
    counted = {k: float(sum(d.work[k] for d in ok))
               for k in ("bytes", "flops", "passes")}
    reduced = None
    if tracer is not None:
        from flashr_bench.tracing import reduce
        reduced = reduce(tracer.events(), t0, t1, loop.span_at)
        tracer = None
    run = Run(sel["cell"], cfg, mix, seconds, setup_s, t1 - t0, done, counted,
              delta, reduced)
    first = {}
    for d in ok:
        first.setdefault(d.op, []).append(round(d.end - d.start, 6))
    log({"phase": "window", "workload": workload, "seed": seed,
         "window_s": t1 - t0, "setup_s": setup_s, "calls": len(done),
         "completed": len(ok), "counted": counted,
         "first_two_s": {k: v[:2] for k, v in first.items()},
         "median_s": {k: statistics.median(v) for k, v in first.items()},
         "errors": sorted({d.error for d in done if not d.ok})[:5],
         "counters": {k: v for k, v in delta.items() if v}})

    wanted = sel["per_layer"] if trace else sel["end_to_end"]
    metrics = {}
    for m in wanted:
        value = manifest.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The comparison: the program's state freed, the reference run on the
    # inputs the benchmark made, after the peak has been read.
    answers = loop.answers(prog)
    for d, ans in answers:
        # The stages the window's answer cannot show, read again from the
        # program's own entry with the call's own parameters (ops/kmeans.py).
        if hasattr(ops[d.op], "stage"):
            ans.update(ops[d.op].stage(prog, d.params))
    del prog
    gc.collect()
    ref = loops.reference_inputs(data)
    checks = compare(ops, answers, ref, mix["limits"], log)
    failed = sum(not d.ok for d in done)
    # Every number the mix holds a limit for has to have been read: an
    # operation that completed no call in the window is not correct.
    correct = (bool(done) and failed == 0 and set(checks) == set(mix["limits"])
               and all(c["value"] <= c["limit"] for c in checks.values()))

    out = {"correct": correct, "attempted": len(done), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = checks
    return out


def compare(ops, answers, ref, limits, log) -> dict:
    """Each kept answer against the reference's answer to the same call;
    per number, the worst over the answers, beside its limit."""
    t0 = time.perf_counter()
    worst: dict = {}
    memo: dict = {}
    for d, ans in answers:
        key = (d.op, json.dumps(d.params, sort_keys=True))
        if key not in memo:
            memo[key] = ops[d.op].reference(ref, d.params, REFERENCE)
        for name, value in ops[d.op].compare(ans, memo[key], ref,
                                             d.params).items():
            if name not in limits:
                raise KeyError(f"no limit for {name}")
            value = float(value) if np.isfinite(value) else float("inf")
            if name not in worst or value > worst[name]:
                worst[name] = value
    checks = {n: {"value": v, "limit": limits[n]}
              for n, v in sorted(worst.items())}
    log({"phase": "checks", "answers": len(answers),
         "reference_s": time.perf_counter() - t0, "checks": checks})
    return checks
