"""Data pipeline: synthetic LM corpus + packed batch iterator; port of
``repro.data``."""
from .pipeline import DataConfig, synthetic_corpus, batch_iterator, make_batch

__all__ = ["DataConfig", "synthetic_corpus", "batch_iterator", "make_batch"]
