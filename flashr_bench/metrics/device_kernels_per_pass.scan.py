"""Kernels the trace holds in the window over the passes the completed
calls count (``work``): what the lowering and the executor launch a
pass."""


def read(run):
    t = run.trace
    if not t or run.counted["passes"] <= 0:
        return None
    return t["kernels"] / run.counted["passes"]
