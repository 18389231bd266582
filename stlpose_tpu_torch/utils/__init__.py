"""Experiment directory, logging and checkpoints of the port
(counterparts of stlpose_tpu/utils)."""
