"""Host ms a training batch waits on the pipeline's decode threads (span
pipeline.load; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.span_ms("pipeline.load")
