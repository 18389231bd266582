"""Host ms a serving call waits for its packed outputs to reach the host
(span serve.fetch; moves images_per_s)."""

from portbench import recorder

read = recorder.span_ms("serve.fetch")
