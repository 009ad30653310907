"""Synthetic data streams."""
from .pipeline import LMTaskStream, SyntheticCIFAR, make_lm_stream

__all__ = ["LMTaskStream", "SyntheticCIFAR", "make_lm_stream"]
