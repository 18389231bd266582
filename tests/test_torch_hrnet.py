"""HRNet: the PyTorch port (stlpose_tpu_torch/models/hrnet.py) against the
JAX reference on the same weights, carried across by
stlpose_tpu_torch/models/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu_torch.config import get_hrnet_config
from stlpose_tpu_torch.models.convert import (hrnet_from_jax,
                                              jax_variables_to_state_dict)
import tests.torch_threads  # noqa: F401  (caps torch's threads)


def random_variables(abstract, seed):
    """Numpy weights for a Flax variable tree (from ``jax.eval_shape`` of
    ``init``): every leaf random, BatchNorm statistics included, so the
    conversion of each leaf kind is exercised. Conv/dense kernels get a
    fan-in scaled normal so activations stay O(1) through deep nets."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def jax_hrnet(name, seed):
    model = JaxHRNet(config=jax_hrnet_config(name))
    abstract = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 256, 192, 3)), train=False))
    return model, random_variables(abstract, seed)


def test_tiny_matches_jax():
    """HRNET_TINY, 3 crops: f32 convolutions summed in another order by
    XLA's and PyTorch's CPU backends; 1e-4 absolute on O(1) heatmaps."""
    model, variables = jax_hrnet("tiny", 0)
    x = np.random.RandomState(1).randn(3, 256, 192, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, x))
    port = hrnet_from_jax(variables, get_hrnet_config("tiny"), device="cpu")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 64, 48, 17)
    assert np.abs(ref).max() > 0.1          # not a trivially small output
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_w32_wiring_one_crop():
    """Full-width HRNet-W32 on one crop pins the wiring of every stage,
    transition and fusion at 32/64/128/256 channels. Random weights grow
    the activations through the residual sums (heatmaps reach ~1e4), so
    the bound is 1e-5 of the output's largest magnitude: f32 summation
    order, far below what a wiring error would give."""
    model, variables = jax_hrnet("w32_256x192", 2)
    x = np.random.RandomState(3).randn(1, 256, 192, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, x))
    port = hrnet_from_jax(variables, get_hrnet_config("w32_256x192"),
                          device="cpu")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 64, 48, 17)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=0)


def test_converter_rejects_mismatched_weights():
    """Weights of another config must not load silently."""
    _, variables = jax_hrnet("tiny", 0)
    sd = jax_variables_to_state_dict(variables)
    assert sd["stem1.conv.weight"].shape == (16, 3, 3, 3)      # OIHW
    assert "stem1.bn.running_var" in sd
    with pytest.raises((KeyError, ValueError)):
        hrnet_from_jax(variables, get_hrnet_config("w32_256x192"),
                       device="cpu")
