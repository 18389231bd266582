"""Kernels' operation and byte counts: one file a kernel."""
