"""Optimizer, schedule and gradient compression of the port's LM training
(PyTorch port of repro.optim): AdamW with low-precision moments, warmup +
cosine, error-feedback int8 compression for the cross-pod reduction."""
from . import adam, compression, schedule
from .adam import AdamConfig

__all__ = ["adam", "compression", "schedule", "AdamConfig"]
