"""Dropless grouped experts: CUDA source, binding, plain version, the
autograd op the MoE layer calls."""
