"""Synthetic data streams."""
from .pipeline import SyntheticCIFAR

__all__ = ["SyntheticCIFAR"]
