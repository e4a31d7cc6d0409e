"""Build helpers for the CUDA sources."""
