"""Command-line tools of the port (counterparts of the JAX ``tools/``)."""
