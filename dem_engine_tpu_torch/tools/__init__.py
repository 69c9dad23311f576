"""Measurement scripts of the port; each needs an NVIDIA GPU and nvcc."""
