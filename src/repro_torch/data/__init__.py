"""The synthetic token pipeline — port of `repro.data`."""
from .pipeline import SyntheticTokens, make_batch_iterator

__all__ = ["SyntheticTokens", "make_batch_iterator"]
