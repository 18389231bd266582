"""Tensor ops of the port (counterparts of stlpose_tpu/ops)."""
