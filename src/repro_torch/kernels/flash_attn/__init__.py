"""Causal (sliding-window) flash attention: plain version, CUDA kernel,
wrapper."""
