"""Host ms an extraction batch waits on the pipeline's decode threads
(span pipeline.load; moves poses_per_s)."""

from portbench import recorder

read = recorder.span_ms("pipeline.load")
