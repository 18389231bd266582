"""Device kernels launched a training iteration (moves train_samples_per_s)."""

from portbench import readers

read = readers.launches_per_call
