"""Seconds from the process's start to the first timed call: imports, the
card's start, loading (on a checkout's first run, building) the kernels,
making the inputs, placing them and one warm call of each kind."""


def read(run):
    return run.setup_s
