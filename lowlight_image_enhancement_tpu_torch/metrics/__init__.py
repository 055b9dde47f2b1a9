"""Metrics of the port (NCHW)."""
