"""Data ingest (PyTorch port of repro.data): external tables streamed into
the disk tier's ``.fmat`` files (``pipeline``)."""
from . import pipeline

__all__ = ["pipeline"]
