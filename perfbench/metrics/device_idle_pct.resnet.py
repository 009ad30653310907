"""Share of the traced call in which no device operation ran, %."""
from perfbench.layers import device_idle_pct as read  # noqa: F401
