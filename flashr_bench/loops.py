"""The one general generator of every traffic mix.

A mix (``traffic/<mix>.json``) is data:

- ``mode``: the program's execution mode for each call (its inputs on the
  card);
- ``loop``: ``closed``, one caller issuing ``calls`` in turn, each after
  the last completed (the only loop so far; a serving cell's open loop
  comes with its cell, PERF.md, Open questions);
- ``check_each``: how many answers of each operation the reference checks;
- ``limits``: the limit of each number compared.

Every seed gets the same work: a closed loop makes the same calls in the
same order; only each call's own parameters are drawn from the seed, so
that no two calls of a run get the same inputs.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Program:
    """What the program is handed: its inputs as fm matrices, and X's raw
    tensor, of which a call may take a window of rows (``ops/summary.py``)."""
    fm: object
    torch: object
    device: object
    X: object
    y: object
    x: object
    mode: str


@dataclasses.dataclass
class Reference:
    """What the reference is handed: the same inputs as raw tensors."""
    x: object
    y: object


@dataclasses.dataclass
class Done:
    """One call: its operation, parameters, work, times and whether it
    completed with an answer."""
    op: str
    params: dict
    work: dict
    start: float
    end: float = float("nan")
    ok: bool = False
    error: str = ""


def reference_inputs(data: dict) -> Reference:
    return Reference(x=data["X"], y=data["y"])


def place(fm, torch, data: dict, mix: dict, device) -> Program:
    """Hand the generated inputs to the program, on the card."""
    return Program(fm, torch, device, fm.conv_R2FM(data["X"]),
                   fm.conv_R2FM(data["y"]), data["X"], mix["mode"])


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Closed:
    """One caller: ``calls`` in turn until the window's time has passed
    (and one round of them at least); the window ends when the last call
    started inside it completes."""

    def __init__(self, mix, ops, cfg, sizes, seed):
        self.mix, self.ops, self.cfg, self.sizes = mix, ops, cfg, sizes
        self.seed = seed
        self.calls = mix["calls"]
        self.done: list[Done] = []
        self.kept: dict = {}
        self.spans: list = []
        self._starts: list = []
        # The ordinal of an operation's j-th call in the window is base + j,
        # of its warm call base - 1: an operation that takes no parameters
        # of its own picks its inputs by the ordinal (ops/summary.py).
        self.base = int(np.random.default_rng([seed, 4]).integers(1 << 20))

    def _params(self, spec, key, ordinal):
        return self.ops[spec["op"]].draw(
            spec, np.random.default_rng([self.seed, *key]), ordinal)

    def warm(self, prog: Program):
        """Each operation of the mix once, at its shapes (iterations cut to
        two: every later iteration runs the second's plan)."""
        for j, spec in enumerate(self.calls):
            params = self._params(spec, (1, j), self.base - 1)
            if "max_iter" in params:
                params["max_iter"] = min(params["max_iter"], 2)
            self.ops[spec["op"]].call(prog, params)
            sync(prog.torch, prog.device)

    def run(self, prog: Program, seconds: float):
        keep = self.mix.get("check_each", 1)
        pick = np.random.default_rng([self.seed, 2])
        seen: dict = {}
        made: dict = {}
        t0 = time.perf_counter()
        i = 0
        while True:
            start = time.perf_counter()
            if start - t0 >= seconds and i >= len(self.calls):
                break
            spec = self.calls[i % len(self.calls)]
            op = self.ops[spec["op"]]
            j = made[spec["op"]] = made.get(spec["op"], -1) + 1
            params = self._params(spec, (0, i), self.base + j)
            d = Done(spec["op"], params, op.work(self.cfg, self.sizes, params),
                     start)
            try:
                ans = op.call(prog, params)
                sync(prog.torch, prog.device)
                d.ok = True
            except Exception as exc:  # noqa: BLE001 - a failed call counts
                d.error = repr(exc)[:300]
            d.end = time.perf_counter()
            self.done.append(d)
            self.spans.append((spec["op"], d.start, d.end))
            if d.ok:
                # A reservoir of ``keep`` answers an operation: a uniform
                # sample, drawn from the seed, of all its completed calls.
                k = seen[spec["op"]] = seen.get(spec["op"], 0) + 1
                slot = self.kept.setdefault(spec["op"], [])
                if len(slot) < keep:
                    slot.append((d, ans))
                else:
                    r = int(pick.integers(k))
                    if r < keep:
                        slot[r] = (d, ans)
                del ans
            i += 1
        return t0, (self.done[-1].end if self.done else t0)

    def span_at(self, t: float) -> str:
        if len(self._starts) != len(self.spans):
            self._starts = [s for _, s, _ in self.spans]
        j = bisect.bisect_right(self._starts, t) - 1
        if j >= 0 and t <= self.spans[j][2]:
            return self.spans[j][0]
        return "between_calls"

    def answers(self, prog):
        return [(d, ans) for slot in self.kept.values() for d, ans in slot]


LOOPS = {"closed": Closed}
