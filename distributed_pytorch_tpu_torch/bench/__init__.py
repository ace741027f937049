"""Timing tools for the port's kernels on a CUDA card (not imported by
the package itself)."""
