"""Non-negative matrix factorization (paper §IV-A) on GenOps; PyTorch port
of repro.algorithms.nmf.

Lee–Seung multiplicative updates for X ≈ W·H with a TALL factor W (n × k,
row-aligned with X) and a SMALL factor H (k × p, host):

    H ← H ⊙ (WᵀX) / (WᵀW·H)        # pass A: two contraction sinks
    W ← W ⊙ (X·Hᵀ) / (W·(H·Hᵀ))    # pass B: row-local

Each iteration is exactly TWO passes, each reading X (and W) once: pass A
co-materializes WᵀX and WᵀW — on the cuda backend ``kernels.xty`` and
``kernels.gram`` — and pass B is a row-local chain writing the new W.  The
Frobenius objective ‖X−WH‖² = ‖X‖² − 2·tr(HᵀWᵀX) + tr(WᵀW·HHᵀ) falls out of
pass A's sinks.  W lives on the tier of X, as in the reference: in host RAM
for a host or disk X.  ``save='disk'`` streams W through the write-through
spill path every iteration and reclaims the previous iteration's file.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from ..core import fm

_EPS = 1e-9


@dataclasses.dataclass
class NMFResult:
    W: fm.FM                  # n × k on the engine's device
    H: np.ndarray             # k × p (host)
    objective: float          # ‖X − WH‖²_F at the last iteration
    objective_trace: list
    iters: int


def nmf(X: fm.FM, k: int = 8, *, max_iter: int = 30, tol: float = 1e-4,
        seed: int = 0, save: str | None = None, mode: str = "auto",
        fuse: bool = True, backend=None, inspect: bool = True) -> NMFResult:
    """Factorize a non-negative tall matrix.  The initial factors come from
    a numpy RNG, as in the reference, so one seed starts both packages at
    the same point."""
    n, p = X.shape
    rng = np.random.default_rng(seed)
    # ‖X‖² (for the objective) and the grand mean (for init scale) in one
    # co-materialized setup pass.
    x2_m, xs_m = fm.materialize(fm.sum_(X ** 2), fm.sum_(X), mode=mode,
                                fuse=fuse, backend=backend)
    x_norm2 = float(fm.as_scalar(x2_m))
    x_mean = float(fm.as_scalar(xs_m)) / float(n * p)
    scale = np.sqrt(max(x_mean, _EPS) / k)
    W = fm.conv_R2FM(
        (rng.uniform(size=(n, k)) * scale + _EPS).astype(np.float32),
        host=fm._fm(X).on_host)
    H = (rng.uniform(size=(k, p)) * scale + _EPS).astype(np.float64)

    trace: list[float] = []
    prev = np.inf
    it = 0
    scope = (fm.inspect_iterations() if inspect
             else contextlib.nullcontext())
    with scope:
        for it in range(1, max_iter + 1):
            # Pass A: both contraction sinks in one fused scan of (X, W).
            WtX_m, WtW_m = fm.materialize(
                fm.crossprod(W, X), fm.crossprod(W), mode=mode, fuse=fuse,
                backend=backend)
            WtX = fm.as_np(WtX_m).astype(np.float64)
            WtW = fm.as_np(WtW_m).astype(np.float64)
            H = H * WtX / (WtW @ H + _EPS)
            # Objective from pass A's sinks, at the H driving the W-update.
            obj = float(x_norm2 - 2.0 * np.sum(WtX * H)
                        + np.sum((WtW @ H) * H))
            trace.append(obj)

            # Pass B: row-local multiplicative update of the tall factor.
            Ht = np.ascontiguousarray(H.T, np.float32)          # p × k
            HHt = np.ascontiguousarray((H @ H.T), np.float32)   # k × k
            num = X @ Ht                                        # n × k
            den = W @ HHt + _EPS                                # n × k
            W_new = W * num / den
            if save:
                fm.persist(W_new, tier=save)
            prev_W = W
            (W,) = fm.materialize(W_new, mode=mode, fuse=fuse,
                                  backend=backend)
            # Reclaim the previous iteration's spill file (each
            # save='disk' materialization writes a fresh one) — only files
            # this fit created; the caller's X is never touched.  A view of
            # the file still held elsewhere keeps its pages mapped.
            if save == "disk" and prev_W.m.on_disk:
                prev_W.m.store.close()
                prev_W.m.store.path.unlink(missing_ok=True)

            if np.isfinite(prev) and \
                    abs(prev - obj) <= tol * max(abs(prev), 1.0):
                break
            prev = obj
    return NMFResult(W=W, H=H, objective=trace[-1], objective_trace=trace,
                     iters=it)
