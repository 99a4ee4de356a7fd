"""Probe of the prefetcher's staged-memory bound on a card (Invariant 6 of
``storage/prefetch.py``): the cell of
``tests/test_torch_cuda.py::test_prefetcher_staged_memory_bounded`` —
40 partitions of 12 MiB, every step delayed on the compute stream — run
many times under the caching allocator's memory history, its consumer's
column sum in two stages as there, or with ``--one-stage`` as one
``sum(0)``, which allocates a 24 MiB reduction buffer on the compute
stream.

    PYTHONPATH=src python3 examples/torch_prefetch_bound_probe.py \
        [--runs 40] [--depth 1] [--one-stage]

For every run it prints the peak of ``torch.cuda.max_memory_allocated``
in partitions against the test's bound, (depth + 2) partitions + 1 MiB,
and replays the allocator's trace to the moment it held the most bytes:
the blocks of half a partition or more then — staged partitions on the
prefetcher's side stream (allocated, or freed by Python and waiting for
their event on the compute stream, ``free_requested``) and what the
consumer's step allocated on its own stream — each with its size and
the Python frame that allocated it.
"""
import argparse
import json

import numpy as np
import torch


def one_run(A, depth, rows, record, one_stage):
    from repro_torch.core.matrix import DenseStore
    from repro_torch.storage import PartitionPrefetcher
    part = rows * A.shape[1] * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if record:
        torch.cuda.memory._record_memory_history(stacks="python",
                                                 max_entries=1 << 17)
    acc = torch.zeros(A.shape[1], device="cuda")
    with PartitionPrefetcher([(0, DenseStore(A))], rows, A.shape[0],
                             depth=depth, device="cuda") as pf:
        for _, _, blocks in pf:          # the test's loop, as written there
            torch.cuda._sleep(5_000_000)
            if one_stage:
                acc += blocks[0].sum(0)
            else:
                acc += blocks[0].view(-1, 128, A.shape[1]).sum(1).sum(0)
            del blocks
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / part
    snap = torch.cuda.memory._snapshot() if record else None
    if record:
        torch.cuda.memory._record_memory_history(enabled=None)
    return peak, snap, part


def _frames(ev):
    return [f"{f['filename'].rsplit('/', 2)[-1]}:{f['line']} {f['name']}"
            for f in ev.get("frames", [])
            if "/torch/" not in f["filename"]][:4]


def replay(snap, part):
    """Walk the device trace: 'live' holds blocks allocated and not yet
    freed by Python, 'pending' those freed by Python whose free has not
    completed (the caching allocator still counts them).  Returns the
    moment the two held the most bytes: the blocks of half a partition or
    more then, in partitions, with their state, stream and the Python
    frame that allocated them."""
    live, pending, best = {}, {}, None
    for ev in snap["device_traces"][0]:
        act, addr = ev["action"], ev["addr"]
        if act == "alloc":
            live[addr] = ev
        elif act == "free_requested":
            pending[addr] = live.pop(addr, ev)
        elif act == "free_completed":
            pending.pop(addr, None)
            live.pop(addr, None)
        else:
            continue
        held = sum(e["size"] for e in live.values()) + sum(
            e["size"] for e in pending.values())
        if best is None or held > best[0]:
            best = (held, ev, [
                dict(state=state, partitions=e["size"] / part,
                     stream="side" if "prefetch.py" in " ".join(_frames(e))
                     else e["stream"], frames=_frames(e)[:2])
                for state, d in (("allocated", live),
                                 ("free_requested", pending))
                for e in d.values() if e["size"] >= part // 2])
    held, ev, blocks = best
    return {"held_partitions": held / part, "event": ev["action"],
            "event_partitions": ev["size"] / part,
            "event_frames": _frames(ev)[:1], "blocks": blocks}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--one-stage", action="store_true",
                    help="the consumer's column sum as one sum(0)")
    args = ap.parse_args()
    rows, p, nparts = 1 << 14, 192, 40      # the test's shape
    A = np.random.default_rng(5).normal(size=(rows * nparts, p)).astype(
        np.float32)
    over = 0
    for r in range(args.runs):
        peak, snap, part = one_run(A, args.depth, rows, True, args.one_stage)
        limit = (args.depth + 2) + (1 << 20) / part
        rec = {"run": r, "depth": args.depth, "one_stage": args.one_stage,
               "peak_partitions": peak,
               "limit_partitions": limit, "over": peak > limit,
               "replay": replay(snap, part)}
        over += rec["over"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"runs": args.runs, "depth": args.depth,
                      "one_stage": args.one_stage, "over_bound": over}),
          flush=True)


if __name__ == "__main__":
    main()
