"""Fused RMSNorm: CUDA source, binding, plain version, any-leading-dims op."""
