"""Host ms a training step spends in its forward: model, loss,
perceptual weighting (span train.forward; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.span_ms("train.forward")
