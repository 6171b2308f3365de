"""Architecture configs and the registry (copies of the JAX package's,
which are data only)."""
