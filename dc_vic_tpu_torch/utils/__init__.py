"""Config loading and component registries (copies of the JAX package's jax-free utils)."""
