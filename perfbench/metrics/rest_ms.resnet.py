"""Wall time a round outside the gradient tick and the comm steps, ms."""
from perfbench.layers import rest_ms as read  # noqa: F401
