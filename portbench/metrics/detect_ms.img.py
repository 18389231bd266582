"""Host ms a serving call spends in the detector's predict (span
serve.detect; moves images_per_s)."""

from portbench import recorder

read = recorder.span_ms("serve.detect")
