"""Synthetic training data (``pipeline``)."""
