"""Models of the port (counterparts of stlpose_tpu/models)."""
