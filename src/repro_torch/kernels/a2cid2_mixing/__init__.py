"""Fused A2CiD2 gossip-event kernel: CUDA source, binding, plain version."""
