"""Comm steps' least HBM time over their measured time, %."""
from perfbench.layers import comm_roofline_pct as read  # noqa: F401
