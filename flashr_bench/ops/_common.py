"""Helpers the operations share."""
from __future__ import annotations

import numpy as np
import torch


def host(a) -> np.ndarray:
    """An answer's array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def device_tensor(fm, x, device) -> torch.Tensor:
    """A materialized fm matrix's data as a tensor on ``device``."""
    data = fm._fm(x).logical_data()
    return torch.as_tensor(data).to(device)


def corr_units(g, g_ref) -> float:
    """max |G - G_ref|_ij / sqrt(G_ref,ii · G_ref,jj): a Gram's error in the
    units of a correlation."""
    g, g_ref = host(g), host(g_ref)
    d = np.sqrt(np.maximum(np.diag(g_ref), 1e-300))
    return float(np.max(np.abs(g - g_ref) / np.outer(d, d)))


def draw_window(spec, ordinal) -> dict:
    """A call's own window of X's rows, for an operation with no parameter
    of its own: all rows but ``cut_rows``, from row ``ordinal mod
    (cut_rows + 1)``.  Consecutive ordinals give distinct windows, so no
    two of ``cut_rows + 1`` consecutive calls read the same input."""
    cut = int(spec["cut_rows"])
    return {"cut_rows": cut, "offset": int(ordinal) % (cut + 1)}


def window(x, params):
    """The rows of ``x`` (a tensor) that the call's window holds: a view."""
    s = params["offset"]
    return x[s:s + x.shape[0] - params["cut_rows"]]
