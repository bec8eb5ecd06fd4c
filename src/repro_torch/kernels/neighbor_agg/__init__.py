"""Weighted neighbor aggregation: plain version, CUDA kernel, wrapper."""
