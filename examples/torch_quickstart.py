"""Quickstart on the PyTorch/CUDA port (twin of examples/quickstart.py):
the R-like GenOps API, lazy fusion, and out-of-core execution.

    PYTHONPATH=src python examples/torch_quickstart.py               # a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Write ordinary (R-flavoured) matrix code; the engine fuses it into one
streaming pass and runs it on the device tier or, out of core, from host
RAM with the same results.
"""
import argparse

import numpy as np

from repro_torch.core import fm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="the engine's device: 'cuda' (default) or 'cpu'")
ap.add_argument("--n", type=int, default=2_000_000)
args = ap.parse_args()
fm.set_conf(device=args.device)

# --- build a "dataset": a tall-and-skinny n x 16 matrix -------------------
n, p = args.n, 16
X_host = np.random.default_rng(0).normal(size=(n, p)).astype(np.float32)

# Device tier
X = fm.conv_R2FM(X_host)

# Lazy R-style expressions: nothing computes yet -----------------------------
Z = (X - 1.0) / 2.0                  # elementwise chain (sapply/mapply)
stats = fm.colSums(Z ** 2)           # aggregation sink
gram = fm.crossprod(Z)               # Gram sink (t(Z) %*% Z)
hist = fm.table_(fm.which_min_row(fm.abs_(Z)), p)  # argmin + groupby

print("virtual handles:", Z.m, stats.m, gram.m, sep="\n  ")

# ONE fused pass materializes every sink together -----------------------------
stats_m, gram_m, hist_m = fm.materialize(stats, gram, hist)
print("colSums(Z^2)[:4] =", fm.as_np(stats_m).ravel()[:4])
print("gram[0,:4]       =", fm.as_np(gram_m)[0, :4])
print("argmin histogram =", fm.as_np(hist_m).ravel())

# --- out-of-core tier: same code, host-resident matrix ----------------------
X_ooc = fm.conv_R2FM(X_host, host=True)        # streamed a partition at a time
Z2 = (X_ooc - 1.0) / 2.0
stats2, gram2 = fm.materialize(fm.colSums(Z2 ** 2), fm.crossprod(Z2))
np.testing.assert_allclose(fm.as_np(stats2), fm.as_np(stats_m), rtol=1e-4)
np.testing.assert_allclose(fm.as_np(gram2), fm.as_np(gram_m), rtol=1e-4)
print("out-of-core result == in-memory result  ✓")

# --- paper algorithms, one line each ----------------------------------------
from repro_torch.algorithms import correlation, summary, svd_tall  # noqa: E402

s = summary(X)
print("summary.mean[:4] =", s.mean[:4])
c = correlation(X)
print("corr diag ≈ 1:", np.allclose(np.diag(c), 1.0, atol=1e-5))
r = svd_tall(X, k=4)
print("top-4 singular values:", np.round(r.s, 1))
