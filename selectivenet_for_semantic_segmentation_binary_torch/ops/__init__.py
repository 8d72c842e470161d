"""Tensor ops of the port (JAX counterpart: ``ops/``)."""
