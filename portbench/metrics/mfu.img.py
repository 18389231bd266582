"""The whole call's share of the card's f32 peak (moves images_per_s)."""

from portbench import readers

read = readers.mfu
