"""Serving programs of the port (counterparts of stlpose_tpu/engines)."""
