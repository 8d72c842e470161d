"""Checkpoint loading and host metrics of the port (JAX counterpart: ``utils/``)."""
