"""Host ms an iteration waits for the next training batch (moves train_samples_per_s)."""

from portbench import readers

read = readers.input_wait_ms
