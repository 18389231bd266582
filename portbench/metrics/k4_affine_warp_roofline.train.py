"""K4 (device-warp crops) share of its roofline (moves train_samples_per_s)."""

from portbench import readers

read = readers.roofline("k4_affine_warp")
