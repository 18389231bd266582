"""Pose training of the port: loss, optimizers and schedulers, train
state (counterparts of stlpose_tpu/train)."""
