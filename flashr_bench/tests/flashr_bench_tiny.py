"""Helpers of the benchmark's CPU tests: tiny CPU runs of its cell, the
harness's look for a card skipped and everything else of a run driven.
Importing this puts the repository and ``src`` on ``sys.path``."""
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Rows the cell runs at here, and the rows a call's window leaves out;
#: its other sizes are the configuration's and the mix's.
TINY_ROWS = 4000
TINY_CUT = 64
SEED = 2 ** 31 + 977
CELL = "friendster32-suite"
#: Limits of the tiny CPU runs where they differ from the cell's: the CPU
#: path of ``correlation`` returns its Gram in float32, one rounding of up
#: to 2^-24 of each entry (about 2e-8 in a correlation at 4,000 rows),
#: while the card's path reads under 1e-9 at the cell's size (PERF.md).
TINY_LIMITS = {"correlation.err": 1e-7}


def tiny_calls(mix: str = "suite") -> list:
    """The mix's calls, each window of rows cut by ``TINY_CUT``."""
    from flashr_bench import manifest
    return [dict(c, cut_rows=TINY_CUT) if "cut_rows" in c else c
            for c in manifest.traffic(mix)["calls"]]


def tiny_run(workload=CELL, seed=SEED, seconds=1.5, trace=False, **kw):
    from flashr_bench import harness, manifest
    limits = {**manifest.traffic("suite")["limits"], **TINY_LIMITS}
    return harness.execute(workload, seed, seconds, trace,
                           t_start=time.perf_counter(), device="cpu",
                           cfg_over={"rows": TINY_ROWS},
                           mix_over={"calls": tiny_calls(), "limits": limits},
                           log=lambda obj: None, **kw)
