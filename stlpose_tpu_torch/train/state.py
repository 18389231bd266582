"""Train state: the model (parameters and BatchNorm statistics), its
optimizer (with its moments and learning rate) and the step count.

Counterpart of ``stlpose_tpu/train/state.py``'s ``PoseTrainState``. The
JAX state is an immutable tree a compiled step returns anew; here the
step updates model and optimizer in place. The optimizer updates the
parameters in the dtype they are stored in: a model trained in bf16
compute keeps them in f32 (``PoseHighResolutionNet(dtype=torch.bfloat16,
param_dtype=torch.float32)``), as flax keeps its params.
"""

from __future__ import annotations

import dataclasses

import torch

from stlpose_tpu_torch.train.optim import build_optimizer


@dataclasses.dataclass
class PoseTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, exp_data: dict
                       ) -> PoseTrainState:
    """A train state around ``model`` (weights as they are) with the
    experiment's optimizer."""
    return PoseTrainState(model=model,
                          optimizer=build_optimizer(exp_data,
                                                    model.parameters()))


def param_count(state: PoseTrainState) -> int:
    """Number of trainable scalars (BatchNorm statistics excluded)."""
    return sum(p.numel() for p in state.model.parameters())
