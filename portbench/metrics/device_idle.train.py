"""Idle share of the card in the profiled stretch (moves train_samples_per_s)."""

from portbench import readers

read = readers.device_idle
