"""Synthetic data streams."""
from .pipeline import (LMTaskStream, SyntheticCIFAR, WorkerStream,
                       lm_batch_specs, make_lm_stream)

__all__ = ["LMTaskStream", "SyntheticCIFAR", "WorkerStream",
           "lm_batch_specs", "make_lm_stream"]
