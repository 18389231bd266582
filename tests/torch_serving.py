"""Helpers of the serving-export tests (tests/test_torch_serving_export*.py):
what an artifact's graph and manifest must name, that its program moves
whole to another device, and tests/test_torch_two_stage.py's bounds for a
two-stage program against the JAX package's."""

import numpy as np
import torch
import torch.export.passes

from stlpose_tpu_torch.kernels import _ops
from stlpose_tpu_torch.serving.packing import _unpack_fused_outputs
from tests.test_torch_two_stage import BUDGET, _heatmap_gaps


def assert_graph_names_its_kernels(program, manifest, expected):
    """The ``stlpose`` operators in an artifact's graph (``program``, as
    loaded on the CPU) are ``expected``, and so is the manifest's
    "kernels"; no ``aten.nonzero`` (the mark of an inlined
    ``roi_align_plain``). Then ``program`` is moved (in place) to the meta
    device: no node's device, parameter, buffer or constant is left on
    the CPU (a constant that the move missed would run the program across
    devices on the card)."""
    assert _ops.operator_names(program.graph) == sorted(expected)
    assert manifest["kernels"] == sorted(expected)
    assert not [n for n in program.graph.nodes
                if "nonzero" in str(n.target)]
    moved = torch.export.passes.move_to_device_pass(program, "meta")
    devices = {str(n.kwargs["device"]) for n in moved.graph.nodes
               if n.kwargs.get("device") is not None}
    assert devices <= {"meta"}, devices
    tensors = list(moved.state_dict.values()) + [
        c for c in moved.constants.values() if isinstance(c, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)


def assert_close_to_jax(got, ref, pose, images, thr, maxima=True):
    """A two-stage program's outputs ``got`` (numpy; crop budget BUDGET)
    against the JAX program's ``ref`` at tests/test_torch_two_stage.py's
    bounds, its preconditions asserted: kept scores 1e-4 apart and from
    ``thr``, and every valid crop's heatmap peak 1e-4 clear of its
    runner-up under ``pose`` (the program's HRNet) on uint8 ``images``.
    ``maxima`` False leaves the heatmap maxima out."""
    sv = ref["sel_valid"]
    assert 0 < ref["picked_valid"].sum() <= BUDGET
    s = np.sort(ref["sel_scores"][sv])
    assert np.diff(s).min() > 1e-4 and np.abs(s - thr).min() > 1e-4
    assert _heatmap_gaps(pose, images, got).min() > 1e-4
    for k in ("sel_valid", "picked_valid", "img_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["sel_boxes"], ref["sel_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["sel_scores"][sv], ref["sel_scores"][sv],
                               atol=1e-5, rtol=0)
    pv = ref["picked_valid"]
    for k in ("crop_kpts", "img_kpts"):
        np.testing.assert_allclose(got[k][pv][..., :2], ref[k][pv][..., :2],
                                   atol=1e-3, rtol=0, err_msg=k)
        if maxima:
            np.testing.assert_allclose(got[k][pv][..., 2],
                                       ref[k][pv][..., 2], atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def live_outputs(live, images):
    """The live two-stage program's outputs on numpy ``images`` as numpy
    arrays (a packed program's buffer unpacked with its layout)."""
    with torch.inference_mode():
        out = live(torch.from_numpy(images))
    if isinstance(out, dict):
        return {k: v.float().numpy() for k, v in out.items()}
    return _unpack_fused_outputs(out.numpy(), live.spec)


def assert_same(got, ref):
    """Two output dicts equal key by key, bit for bit."""
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(ref[k], np.float32),
                                      err_msg=k)
