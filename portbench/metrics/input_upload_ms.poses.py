"""Host ms an extraction batch spends uploading its host arrays (span
pipeline.upload; moves poses_per_s)."""

from portbench import recorder

read = recorder.span_ms("pipeline.upload")
