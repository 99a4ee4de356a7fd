"""The kernels' share of the roofline: the counted work's least time on the
card, max(bytes / 3.35 TB/s, float32 operations / 67 TFLOP/s), over the
summed device time of every kernel in the trace of the window.  The same
work whatever implements it."""
from flashr_bench.readers import kernels_roofline_pct


def read(run):
    return kernels_roofline_pct(run)
