"""The model's training FLOPs over wall time, % of the f32 peak."""
from perfbench.layers import mfu_pct as read  # noqa: F401
