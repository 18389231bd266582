"""Train and eval steps of the port on one device (counterparts of
stlpose_tpu/parallel/steps.py)."""
