"""Data (PyTorch port of repro.data): the token stream of LM training and
external tables streamed into the disk tier's ``.fmat`` files
(``pipeline``)."""
from . import pipeline
from .pipeline import (DataConfig, DataIterator, TokenSource, ingest_binary,
                       ingest_csv)

__all__ = ["pipeline", "DataConfig", "DataIterator", "TokenSource",
           "ingest_binary", "ingest_csv"]
