"""A tall dense float32 matrix X ~ N(0, 1) and a 0/1 response y from a
logistic model with a seeded beta, made on the device from the seed (a
frozen copy of ``make_data`` in the port's smoke script, seeded by the
run).

Keys of the configuration: ``rows``, ``cols``, ``beta_low``, ``beta_high``.
"""
from __future__ import annotations

import numpy as np


def input_bytes(cfg: dict) -> dict:
    """Bytes of one read of each input."""
    return {"X": cfg["rows"] * cfg["cols"] * 4, "y": cfg["rows"] * 4}


def make(torch, cfg: dict, seed: int, device) -> dict:
    """``{"X": (rows, cols) float32, "y": (rows, 1) float32}`` on
    ``device``: X in one call of a generator on the device, y in two."""
    n, p = cfg["rows"], cfg["cols"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, p), generator=gen, device=device)
    beta = torch.as_tensor(
        np.random.default_rng(seed).uniform(cfg["beta_low"], cfg["beta_high"],
                                            p),
        dtype=torch.float32, device=device)
    prob = torch.sigmoid(x @ beta)
    y = (torch.rand(n, generator=gen, device=device) < prob).float()
    del prob
    return {"X": x, "y": y.reshape(-1, 1)}
