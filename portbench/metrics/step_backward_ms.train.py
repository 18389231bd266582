"""Host ms a training step spends in zero_grad and autograd's backward
(span train.backward; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.span_ms("train.backward")
