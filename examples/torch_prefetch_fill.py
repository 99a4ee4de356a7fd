#!/usr/bin/env python3
"""How the partition prefetcher should fill its pinned slots, on one card.

    PYTHONPATH=src python3 examples/torch_prefetch_fill.py [--rows N]

The prefetcher (``repro_torch.storage.prefetch``) copies each partition
of a numpy host store into a pinned slot before its asynchronous
host→device copy.  That fill runs on the prefetcher's worker thread while
the compute thread issues the previous partition's step, so the two
compete for the host's cores.  This probe times the fill variants against
each other and against synchronous staging, in one process, in turns
(each variant twice, ABBA order):

* ``sync``   — ``prefetch=False``: pageable copies on the compute thread;
* ``torch``  — ``pinned.copy_(torch.from_numpy(block))``, torch's CPU
  copy on its intra-op threads;
* ``memmove`` / ``memmove4`` — ``ctypes.memmove`` (a C call that releases
  the GIL) of the block's bytes, on the worker thread / split over four
  threads.

First each fill alone (8 MiB blocks into a pinned buffer, GB/s), then the
out-of-core calls of path e of ``chip_smoke.py`` — summary, correlation,
``glm(max_iter=3)`` — over an N × 32 float32 host matrix, untraced: the
wall ms a pass and a pass's share of the pipeline's counters (fill, side
stream copy, queue wait, steps).  One JSON line each, then the card's name
and power limit as ``nvidia-smi`` prints them.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, "src")

SECONDS = ("stage_read_seconds", "stage_copy_seconds",
           "prefetch_wait_seconds", "device_step_seconds", "combine_seconds")


def emit(obj):
    print(json.dumps(obj), flush=True)


def _alloc(self, key, arr):
    """The slot's pinned buffer for ``key``, sized for ``arr``."""
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    buf = self.bufs.get(key)
    if buf is None or buf.dtype != dtype or buf.numel() < arr.size:
        buf = self.bufs[key] = torch.empty(arr.size, dtype=dtype,
                                           pin_memory=True)
    return buf[:arr.size].view(arr.shape)


_POOL = concurrent.futures.ThreadPoolExecutor(4)


def _memmove_fill(self, key, arr):
    dst = _alloc(self, key, arr)
    ctypes.memmove(dst.data_ptr(), arr.ctypes.data, arr.nbytes)
    return dst


def _memmove4_fill(self, key, arr):
    dst = _alloc(self, key, arr)
    d, s, n = dst.data_ptr(), arr.ctypes.data, arr.nbytes
    cuts = [n * i // 4 for i in range(5)]
    list(_POOL.map(lambda i: ctypes.memmove(d + cuts[i], s + cuts[i],
                                            cuts[i + 1] - cuts[i]),
                   range(4)))
    return dst


def fill_alone(variants, prefetch):
    """GB/s of each fill variant alone: 8 MiB blocks of a 1 GiB array."""
    a = np.random.default_rng(0).normal(size=(1 << 25, 8)).astype(np.float32)
    rows = (8 << 20) // (8 * 4)
    out = {}
    for name, fill in variants.items():
        slot = prefetch._PinnedSlot()
        fill(slot, 0, a[:rows])
        t0 = time.perf_counter()
        for s in range(0, a.shape[0], rows):
            fill(slot, 0, a[s:s + rows])
        out[name] = a.nbytes / (time.perf_counter() - t0) / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.algorithms import correlation, glm, summary
    from repro_torch.core import fm
    from repro_torch.observability import metrics
    from repro_torch.storage import prefetch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    fm.set_conf(device="cuda", backend="cuda")
    build.build_all()                      # not inside the first timing
    variants = {"torch": prefetch._PinnedSlot.fill,
                "memmove": _memmove_fill, "memmove4": _memmove4_fill}
    emit({"phase": "fill_alone", "gb_s": fill_alone(variants, prefetch)})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2016)
    x = torch.randn((args.rows, 32), generator=gen, device="cuda")
    y = (torch.rand(args.rows, generator=gen, device="cuda")
         < torch.sigmoid(x[:, 0])).float()
    XH = fm.conv_R2FM(x.cpu().numpy(), host=True)
    YH = fm.conv_R2FM(y.cpu().numpy(), host=True)
    del x, y
    calls = (("summary", lambda: summary(XH)),
             ("correlation", lambda: correlation(XH)),
             ("glm", lambda: glm(XH, YH, family="logistic", max_iter=3)))
    order = ["sync", "torch", "memmove", "memmove4",
             "memmove4", "memmove", "torch", "sync"]
    real = prefetch._PinnedSlot.fill
    for run, name in enumerate(order):
        prefetch._PinnedSlot.fill = variants.get(name, real)
        try:
            with fm.conf(prefetch=name != "sync"):
                for call, fn in calls:
                    st0 = fm.exec_stats()
                    sec0 = {k: metrics.root_counter(k) for k in SECONDS}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    passes = fm.exec_stats()["passes"] - st0["passes"]
                    emit({"phase": "ooc", "run": run, "fill": name,
                          "call": call, "passes": passes,
                          "ms_per_pass": wall / passes * 1e3,
                          **{k.replace("_seconds", "_ms_per_pass"):
                             (metrics.root_counter(k) - sec0[k])
                             / passes * 1e3 for k in SECONDS}})
        finally:
            prefetch._PinnedSlot.fill = real
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
