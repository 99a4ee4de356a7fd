"""The whole window's share of the card's bandwidth: counted bytes / 3.35
TB/s over the traced window.  It still bounds a gain after a later change
takes a kernel off the path."""
from flashr_bench import peaks


def read(run):
    t = run.trace
    if not t or run.counted["bytes"] <= 0:
        return None
    return 100.0 * run.counted["bytes"] / peaks.HBM_BYTES_S / t["window_s"]
