"""GB/s of algorithm work: the bytes each completed call must read at the
least (``ops/<op>.py``'s ``work``, one read of each input a pass its data
dependences force) over the window, inputs on the card."""
from flashr_bench.readers import rate_gb_s


def read(run):
    return rate_gb_s(run)
