"""Engines and serving programs of the port (counterparts of
stlpose_tpu/engines)."""

from stlpose_tpu_torch.engines.evaluator import PoseEvaluator
from stlpose_tpu_torch.engines.trainer import PoseTrainer
