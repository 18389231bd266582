"""Host ms a batch waits for the extraction collate (moves poses_per_s)."""

from portbench import readers

read = readers.input_wait_ms
