"""Flash attention: CUDA source, binding, plain version, model-layout op."""
