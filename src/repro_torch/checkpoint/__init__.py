"""Checkpoints in the JAX package's format (``checkpoint``)."""
