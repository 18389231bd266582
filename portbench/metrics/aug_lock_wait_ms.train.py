"""The decode threads' ms a training batch waiting for the augmentation
sampler, summed (counter pipeline.aug_lock_wait_s of each pipeline.batch
call, the median; moves train_samples_per_s)."""

from portbench import recorder

read = recorder.counter_ms_per_span("pipeline.aug_lock_wait_s",
                                    "pipeline.batch")
