"""The f32 weight products on the tensor cores: CUDA source, binding,
plain version, and the differentiable, vmap-aware ``dense`` op."""
