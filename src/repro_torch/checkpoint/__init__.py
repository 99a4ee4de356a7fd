"""Atomic, async checkpointing (PyTorch port of repro.checkpoint)."""
from . import checkpoint
from .checkpoint import Checkpointer

__all__ = ["checkpoint", "Checkpointer"]
