"""K2 (serving crops) share of its roofline (moves images_per_s)."""

from portbench import readers

read = readers.roofline("k2_crop_warp")
