"""Mean device time of one gradient tick, ms (CUDA events around the
grad_fn)."""
from perfbench.layers import grad_ms as read  # noqa: F401
