"""K5 (greedy NMS) share of its roofline (moves images_per_s)."""

from portbench import readers

read = readers.roofline("k5_nms")
