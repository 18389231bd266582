"""K3 (RoIAlign) share of its roofline (moves images_per_s)."""

from portbench import readers

read = readers.roofline("k3_roi_align")
