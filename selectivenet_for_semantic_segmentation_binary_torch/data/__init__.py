"""Fold lists, patch dataset and device feed of the port (JAX counterpart:
``data/``)."""
