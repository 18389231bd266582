"""K1's share of its roofline (moves train_samples_per_s)."""

from portbench import readers

read = readers.roofline("k1_decode")
