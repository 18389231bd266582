"""Device kernels launched a serving call (moves images_per_s)."""

from portbench import readers

read = readers.launches_per_call
