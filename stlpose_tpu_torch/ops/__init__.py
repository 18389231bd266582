"""Tensor ops of the port (counterparts of stlpose_tpu/ops)."""

from stlpose_tpu_torch.ops.pck import pck_accuracy, pck_accuracy_np
