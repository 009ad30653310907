"""Synthetic data streams."""
from .pipeline import (LMTaskStream, SyntheticCIFAR, WorkerStream,
                       make_lm_stream)

__all__ = ["LMTaskStream", "SyntheticCIFAR", "WorkerStream",
           "make_lm_stream"]
