"""Optimizer and schedule of the port's LM training (PyTorch port of
repro.optim): AdamW with low-precision moments, warmup + cosine.  Gradient
compression waits for the sharded train step (ROADMAP A14)."""
from . import adam, schedule
from .adam import AdamConfig

__all__ = ["adam", "schedule", "AdamConfig"]
