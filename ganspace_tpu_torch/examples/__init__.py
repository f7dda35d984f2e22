"""Examples of the port's extension points (``examples/`` of the JAX package)."""
