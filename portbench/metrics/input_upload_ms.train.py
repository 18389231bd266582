"""Host ms a training batch spends uploading its host arrays (span
pipeline.upload; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.span_ms("pipeline.upload")
