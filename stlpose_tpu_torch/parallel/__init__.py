"""The port's steps, on one device or data-parallel over a mesh of ranks,
and the torch.distributed plumbing (counterparts of
stlpose_tpu/parallel/)."""
