"""Serving load generator: concurrent tenants over one disk matrix (PyTorch
port of repro.launch.serve).

    PYTHONPATH=src python -m repro_torch.launch.serve --clients 4 --waves 3

Drives the async serving layer (``fm.serve`` / `core/serve.Engine`) the
way FlashR is deployed: many clients concurrently request independent
analytics over the SAME named disk-resident matrix.  Two arms over the
same request traffic:

  serial   every request is its own ``fm.materialize`` — k clients × w
           waves pay k·w full scans of the source;
  serve    requests go through an Engine admission window — each wave's k
           same-source strangers coalesce onto ONE streaming drive
           (``exec_stats()['streams'] == waves``), so the disk tier is read
           once a wave, not once a request.

Prints one ``BENCH {json}`` row per arm: requests/s and p50/p99 latency
(reported, not gated: thread scheduling jitters them), plus the
deterministic engine evidence — ``streams`` and ``bytes_per_request``
(bytes streamed off the disk tier over requests served); the serve arm's
value is the serial arm's divided by the number of clients.  A request's
latency runs until its result's device work has finished (a serial
request ends in a synchronize; a served one resolves only then), and the
arm's wall time until the card is idle.

The arms run with mid-stream admission off and the window held open for
exactly one wave (``max_window_requests=clients`` and a client-side
barrier), so the schedule — and every counter — is deterministic.  The
engine runs on the configured device: a card, unless the caller has set
``fm.set_conf(device="cpu")``.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import time

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")


def _request_mix(fm):
    """The per-client request mix: client i of a wave submits mix[i %
    len].  All single-pass over the shared source, so a wave forms ONE
    group."""
    return (fm.colMeans, fm.colSums, lambda X: fm.colMaxs(X), fm.sum_)


def _percentile(sorted_us, q):
    if not sorted_us:
        return 0.0
    idx = min(len(sorted_us) - 1, int(round(q * (len(sorted_us) - 1))))
    return sorted_us[idx]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--window-ms", type=float, default=2000.0,
                    help="admission window upper bound; each wave closes "
                         "it early via max_window_requests")
    ap.add_argument("--partition-kib", type=int, default=256)
    ap.add_argument("--name", default="serve_loadgen_x")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from repro_torch.core import fm
    from repro_torch.core import lowering
    from repro_torch.core import materialize as mz
    from repro_torch.observability import metrics
    from repro_torch.storage import registry

    with fm.conf(io_partition_bytes=args.partition_kib << 10):
        device = registry.device()  # raises when CUDA is asked and absent
        backend = lowering.resolve_backend(None)
        rng = np.random.default_rng(0)
        X_np = rng.normal(size=(args.n, args.p)).astype(np.float32)
        X = fm.load_dense_matrix(X_np, args.name)  # the disk tier
        del X_np
        mix = _request_mix(fm)
        k, waves = args.clients, args.waves
        n_requests = k * waves
        records = []

        for arm in ("serial", "serve"):
            mz.clear_plan_cache()
            mz.reset_exec_stats()
            latencies_us = []
            lat_lock = threading.Lock()
            _sync(device)
            t_arm = time.perf_counter()

            if arm == "serial":
                for _ in range(waves):
                    for i in range(k):
                        t0 = time.perf_counter()
                        fm.materialize(mix[i % len(mix)](X))
                        _sync(device)
                        latencies_us.append(
                            1e6 * (time.perf_counter() - t0))
            else:
                eng = fm.serve(window_ms=args.window_ms,
                               max_window_requests=k,
                               midstream_admission=False)
                try:
                    for _ in range(waves):
                        barrier = threading.Barrier(k)
                        errors = []

                        def client(i):
                            try:
                                out = mix[i % len(mix)](X)
                                barrier.wait(timeout=30)
                                t0 = time.perf_counter()
                                eng.submit(out).result(timeout=300)
                                us = 1e6 * (time.perf_counter() - t0)
                                with lat_lock:
                                    latencies_us.append(us)
                            except Exception as exc:  # noqa: BLE001
                                errors.append(exc)

                        threads = [threading.Thread(target=client, args=(i,))
                                   for i in range(k)]
                        for t in threads:
                            t.start()
                        for t in threads:
                            t.join(timeout=600)
                        if errors:
                            raise errors[0]
                        if any(t.is_alive() for t in threads):
                            raise RuntimeError("a client did not finish")
                finally:
                    eng.close()

            _sync(device)
            wall_s = time.perf_counter() - t_arm
            st = mz.exec_stats()
            streamed = int(metrics.root_counter("bytes_streamed"))
            lat = sorted(latencies_us)
            record = {
                "bench": "serve", "workload": "mixed-analytics",
                "arm": arm, "mode": "disk", "backend": backend,
                "n": args.n, "p": args.p,
                "clients": k, "waves": waves, "requests": n_requests,
                "us_per_call": round(1e6 * wall_s / n_requests, 1),
                "rps": round(n_requests / max(wall_s, 1e-9), 1),
                "us_p50": round(_percentile(lat, 0.50), 1),
                "us_p99": round(_percentile(lat, 0.99), 1),
                # Deterministic engine evidence: serve = one stream a
                # wave; serial = one a request.
                "streams": st["streams"],
                "bytes_per_request": streamed // n_requests,
            }
            print("BENCH " + json.dumps(record, sort_keys=True), flush=True)
            log.info(
                "%-6s %d requests (%d clients x %d waves): %.1f req/s, "
                "p50 %.1fms p99 %.1fms, streams=%d, %.2f MiB/request",
                arm, n_requests, k, waves, record["rps"],
                record["us_p50"] / 1e3, record["us_p99"] / 1e3,
                record["streams"], record["bytes_per_request"] / 2**20)
            records.append(record)

    serial, served = records
    if served["streams"] != waves:
        raise RuntimeError(
            "window coalescing broken: expected one stream per wave, got "
            f"{served['streams']} for {waves} waves")
    if served["bytes_per_request"] >= serial["bytes_per_request"]:
        raise RuntimeError("serve arm must read strictly fewer bytes than "
                           "serial")
    log.info("coalescing: %d same-source requests/window -> 1 stream; "
             "bytes/request %.2f MiB -> %.2f MiB (%.1fx)",
             k, serial["bytes_per_request"] / 2**20,
             served["bytes_per_request"] / 2**20,
             serial["bytes_per_request"]
             / max(served["bytes_per_request"], 1))
    return records


def run(argv=None):
    """Entry point for a regression gate: the two arms' records."""
    return main(argv)


if __name__ == "__main__":
    main()
