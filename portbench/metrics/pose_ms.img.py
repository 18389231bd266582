"""Host ms a serving call spends in HRNet on the crops (span serve.pose;
moves images_per_s)."""

from portbench import recorder

read = recorder.span_ms("serve.pose")
