"""The port's perceptual-loss weighting of the pose loss and its
perceptual-loss dictionary (``train/loss.py``) against the JAX package's.
Split from ``tests/test_torch_train_step.py`` so that each test file of
the port holds at most 12 tests (pytest-xdist's ``--dist loadfile``
queues files largest first)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.train import loss as jax_loss
from stlpose_tpu_torch.train import loss as port_loss
from tests.test_torch_train_step import _exp
import tests.torch_threads  # noqa: F401  (caps torch's threads)


@pytest.mark.parametrize("training", [
    {}, {"lambda_D": 0.7, "lambda_P": 0.3}, {"perceptual_loss": False}])
def test_perceptual_loss_weighting_matches_jax(training):
    """The "add" scheme, the lambda-weighted sum, and off."""
    exp = _exp(**training)
    perc = np.float32([0.3, 1.2, 0.05, 2.0])
    ref = jax_loss.apply_perceptual_loss(exp, jnp.float32(0.8), perc)
    got = port_loss.apply_perceptual_loss(exp, torch.tensor(0.8), perc)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


def test_perceptual_loss_dict_read(tmp_path):
    exp = _exp()
    path = tmp_path / "perceptual_loss_dict_alpha_0.5_styles_all.json"
    path.write_text(json.dumps({"a.jpg": 0.25}))
    assert port_loss.load_perceptual_loss_dict(exp, str(tmp_path)) == \
        jax_loss.load_perceptual_loss_dict(exp, str(tmp_path))
    assert port_loss.load_perceptual_loss_dict(
        _exp(perceptual_loss=False), str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        port_loss.load_perceptual_loss_dict(exp, str(tmp_path / "none"))
