"""The device's idle share of the traced window: 100 · (1 - the union of
its kernels, copies and fills / the window)."""
from flashr_bench.readers import idle_pct


def read(run):
    return idle_pct(run)
