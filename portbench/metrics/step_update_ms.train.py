"""Host ms a training step spends in the optimizer's update (span
train.update; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.span_ms("train.update")
