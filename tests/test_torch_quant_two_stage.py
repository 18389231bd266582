"""The quantized serving flavor as a whole: stlpose_tpu_torch's fused
two-stage program with folded BatchNorm and the int8 RoI patch pyramid,
in f32 and in bf16, against stlpose_tpu's ``build_fused_two_stage`` on the
same weights (tiny detector + tiny HRNet, two 128-px uint8 images); and
the port's rules for the new flavors.

The JAX detector takes its RoIAlign from
``stlpose_tpu.ops.pallas_roi.multilevel_roi_align_pallas_batched`` at call
time; the tests point that attribute at the same function in interpret
mode, so the tiny config (C = 32, not a multiple of 128) quantizes as the
full-width one does instead of taking the XLA path, which ignores
``patch_quant``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stlpose_tpu.ops.pallas_roi as jax_pallas_roi
import stlpose_tpu_torch.models.faster_rcnn as port_frcnn
from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.engines.vase_evaluator import \
    build_fused_two_stage as jax_build
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.models.faster_rcnn import \
    select_proposals as jax_select_proposals
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.models.hrnet import fold_batchnorms as jax_fold
from stlpose_tpu.models.quantize import fold_frcnn_trunk as jax_fold_frcnn
from stlpose_tpu_torch.config import (FASTER_RCNN_TINY, HRNET_TINY,
                                      IMAGENET_MEAN, IMAGENET_STD)
from stlpose_tpu_torch.engines.vase_evaluator import build_fused_two_stage
from stlpose_tpu_torch.kernels import roi_align as _k3
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.affine import coords_to_center_scale
from stlpose_tpu_torch.ops.nms import top_k
from stlpose_tpu_torch.ops.warp import crop_from_center_scale_batched
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import random_variables
from tests.test_torch_two_stage import ROOT, _imported_roots
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B = 2
# bf16 has 8 significant bits: one step of a value in [0.5, 1) is 2^-8
STEP = 2.0 ** -8


@pytest.fixture
def interpret_roi(monkeypatch):
    monkeypatch.setattr(jax_pallas_roi, "multilevel_roi_align_pallas_batched",
                        functools.partial(
                            jax_pallas_roi.multilevel_roi_align_pallas_batched,
                            interpret=True))


def _pose_variables():
    pose = JaxHRNet(config=jax_hrnet_config("tiny"))
    return random_variables(jax.eval_shape(lambda: pose.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 1)


def _numpy(out):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in out.items()}


def _jax_numpy(out):
    return {k: np.asarray(v).astype(np.float32) if v.dtype == jnp.bfloat16
            else np.array(v) for k, v in out.items()}


def _crop_slots(out, budget):
    """The flat detection slot of every crop, rebuilt from the outputs with
    the program's own compaction key, summed in the scores' dtype."""
    sv = torch.tensor(out["sel_valid"]).reshape(-1)
    sc = torch.tensor(out["sel_scores"]).reshape(-1).to(out["dtype"])
    key = (sv * 10.0).to(sc.dtype) + torch.where(sv, sc, 0.0)
    return top_k(key, budget)[1].numpy()


def test_fused_f32_roi8_folded_matches_jax(interpret_roi):
    """f32 compute, folded BatchNorm in both networks, RoIAlign on the int8
    patch pyramid, at the f32 slice's tolerances
    (tests/test_torch_two_stage.py): sel_valid, picked_valid and img_idx
    exact; boxes 1e-3 px, scores 1e-5; keypoints 1e-3 px, maxvals 1e-4
    relative. The JAX side folds with its own fold functions, the port
    converts the live-BatchNorm weights and folds them itself. Stable
    because every kept score is 1e-4 clear of its neighbours and of
    ``bbox_thr``, and every valid crop's heatmap peak 1e-4 clear of its
    runner-up (asserted)."""
    thr, max_dets, budget = 0.555, 4, 6
    _, dv = jax_detector(0)
    pv = _pose_variables()
    det = JaxFasterRCNN(JAX_TINY, pallas_roi=True, roi_patch_quant=True,
                        trunk_quant="folded")
    pose = JaxHRNet(config=jax_hrnet_config("tiny"), folded=True)
    images = np.random.RandomState(2).randint(0, 256, (B, 128, 128, 3),
                                              dtype=np.uint8)
    ref = _jax_numpy(jax.jit(jax_build(
        det, pose, bbox_thr=thr, max_dets=max_dets, budget=budget,
        pallas_crop=False))(jax_fold_frcnn(dv), jax_fold(pv),
                            jnp.asarray(images)))
    port_det = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu",
                                    roi_patch_quant=True,
                                    trunk_quant="folded")
    port_pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu", folded=True)
    got = _numpy(build_fused_two_stage(port_det, port_pose, bbox_thr=thr,
                                       max_dets=max_dets, budget=budget,
                                       device="cpu")(images))

    sv = ref["sel_valid"]
    assert 0 < ref["picked_valid"].sum() < budget
    s = np.sort(ref["sel_scores"][sv])
    assert np.diff(s).min() > 1e-4 and np.abs(s - thr).min() > 1e-4
    for k in ("sel_valid", "picked_valid", "img_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["sel_boxes"], ref["sel_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["sel_scores"][sv], ref["sel_scores"][sv],
                               atol=1e-5, rtol=0)
    pv_ = ref["picked_valid"]
    gaps, _ = _heatmap_gaps(port_pose, images,
                            dict(got, dtype=torch.float32), budget)
    assert gaps[pv_].min() > 1e-4
    for k in ("crop_kpts", "img_kpts"):
        np.testing.assert_allclose(got[k][pv_][..., :2], ref[k][pv_][..., :2],
                                   atol=1e-3, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k][pv_][..., 2], ref[k][pv_][..., 2],
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def _heatmap_gaps(pose, images_u8, out, budget):
    """(budget, J) top-1 minus top-2 value of every heatmap, the crops
    rebuilt from the outputs as the program makes them."""
    slots = _crop_slots(out, budget)
    boxes = torch.from_numpy(out["sel_boxes"]).reshape(-1, 4)[slots]
    c, s = coords_to_center_scale(boxes, 0.75)
    imgs = torch.from_numpy(images_u8).float() / 255.0 * 255.0
    crops = crop_from_center_scale_batched(
        imgs, c, s, torch.from_numpy(out["img_idx"]), (192, 256))
    x = (crops / 255.0 - torch.from_numpy(IMAGENET_MEAN)) / \
        torch.from_numpy(IMAGENET_STD)
    with torch.inference_mode():
        hm = pose(x).permute(0, 3, 1, 2).flatten(2)
    top2 = hm.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy(), hm


def test_fused_bf16_roi8_matches_jax_on_pinned_proposals(interpret_roi,
                                                         monkeypatch):
    """bf16 compute, folded BatchNorm, int8 RoI patch pyramid: the serving
    flavor. Held on the proposals: the RPN's bf16 logits tie at the
    per-level top-k and in NMS, and two bf16 programs that round at other
    points select different proposals from the same weights (41 of 64
    differ by more than 1 px at this size), so the port's proposal stage
    returns the JAX program's own proposals (its ``select_proposals`` on
    its own bf16 RPN outputs) and everything after it runs in the port.
    The RPN's outputs themselves are held in tests/test_torch_bf16.py.

    Weights: detector seed 64, its classifier's kernel scaled by 8 so
    that person scores spread over (0, 1) instead of lying within a few
    bf16 steps of 0.5, where top-k order is a coin toss; two detections per
    image, all four crops picked. The discrete outputs hold only where no
    score lies within its perturbation of a decision: of the next
    detection's score, or of a rounding boundary of the compaction key
    (10 + score, rounded to bf16 in steps of 1/16 by both programs). These
    inputs are such a case, with the scores of each image 0.14 apart and
    1/64 clear of the key's boundaries; about two thirds of the seeds tried
    were not.

    - sel_valid, picked_valid and img_idx are equal;
    - each image's detections are the same set: every JAX box has a port
      box within 1 px (a bf16 box delta, a few steps off, moves a corner of
      a box under 128 px by well under a pixel), and their scores lie
      within 8 bf16 steps (2^-5: the class logits carry the box head's
      accumulated rounding, times the classifier's gain of 8);
    - keypoints of the same detection (matched by box) are compared where
      the port's heatmap has a top-1/top-2 gap above twice its own bf16
      perturbation (the largest distance of that heatmap from the f32
      network's on the same crop, which moves each of the two values), the
      margin rule of tests/test_bf16_accuracy.py; at least four joints
      qualify. There the peaks are the same pixel (crop-space keypoints
      equal) and the image-space keypoints agree to the 1-px box
      difference plus half a heatmap pixel (a flipped quarter-pixel
      refinement on either side)."""
    max_dets, budget = 2, 4
    _, dv = jax_detector(64)
    dv["params"]["box_head"]["cls_score"]["kernel"] = \
        dv["params"]["box_head"]["cls_score"]["kernel"] * 8.0
    dvf = jax_fold_frcnn(dv)
    pv = _pose_variables()
    det = JaxFasterRCNN(JAX_TINY, dtype=jnp.bfloat16, pallas_roi=True,
                        roi_patch_quant=True, trunk_quant="folded")
    pose = JaxHRNet(config=jax_hrnet_config("tiny"), dtype=jnp.bfloat16,
                    folded=True)
    images = np.random.RandomState(2).randint(0, 256, (B, 128, 128, 3),
                                              dtype=np.uint8)
    ref = _jax_numpy(jax.jit(jax_build(
        det, pose, bbox_thr=0.0, max_dets=max_dets, budget=budget,
        pallas_crop=False))(dvf, jax_fold(pv), jnp.asarray(images)))

    def jax_proposals(v, x):
        _, logits, deltas = det.module.apply(v, x, train=False)
        anchors = det._get_anchors(logits)
        return jax.vmap(lambda lg, dl: jax_select_proposals(
            JAX_TINY, anchors, list(lg), list(dl), False)[0])(
                tuple(logits), tuple(deltas))

    props = torch.from_numpy(np.array(jax.jit(jax_proposals)(
        dvf, jnp.asarray(images, jnp.float32) / 255.0)))
    monkeypatch.setattr(port_frcnn, "select_proposals",
                        lambda *args: (props, None))
    port_det = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu",
                                    dtype=torch.bfloat16,
                                    roi_patch_quant=True,
                                    trunk_quant="folded")
    port_pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu",
                               dtype=torch.bfloat16, folded=True)
    got = _numpy(build_fused_two_stage(port_det, port_pose, bbox_thr=0.0,
                                       max_dets=max_dets, budget=budget,
                                       device="cpu")(images))

    for k in ("sel_valid", "picked_valid", "img_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["picked_valid"].all()
    # the same detections in each image, matched by box
    match = {}
    for b in range(B):
        for i in range(max_dets):
            d = np.abs(got["sel_boxes"][b] - ref["sel_boxes"][b, i]).max(-1)
            j = int(d.argmin())
            assert d[j] <= 1.0, (b, i, d)
            assert abs(got["sel_scores"][b, j] -
                       ref["sel_scores"][b, i]) <= 8 * STEP
            match[b * max_dets + i] = b * max_dets + j
        assert len(set(match.values())) == (b + 1) * max_dets

    # keypoints of the same detection where the port's peaks are clear
    gaps, hm = _heatmap_gaps(port_pose, images,
                             dict(got, dtype=torch.bfloat16), budget)
    f32_pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu", folded=True)
    _, hm32 = _heatmap_gaps(f32_pose, images,
                            dict(got, dtype=torch.bfloat16), budget)
    margin = 2 * (hm - hm32).abs().amax(-1).numpy()          # (budget, J)
    got_slot = {s: k for k, s in enumerate(_crop_slots(
        dict(got, dtype=torch.bfloat16), budget))}
    ref_slots = _crop_slots(dict(ref, dtype=torch.bfloat16), budget)
    n = 0
    for k_ref, s_ref in enumerate(ref_slots):
        k = got_slot[match[int(s_ref)]]
        clear = gaps[k] > margin[k]
        n += int(clear.sum())
        np.testing.assert_allclose(got["crop_kpts"][k][clear][:, :2],
                                   ref["crop_kpts"][k_ref][clear][:, :2],
                                   atol=1e-3, rtol=0)
        # image pixels per heatmap pixel of this crop: its width / 48
        _, scale = coords_to_center_scale(
            torch.from_numpy(ref["sel_boxes"].reshape(-1, 4)[s_ref]), 0.75)
        px = float(scale[0]) * 200.0 / 48.0
        np.testing.assert_allclose(got["img_kpts"][k][clear][:, :2],
                                   ref["img_kpts"][k_ref][clear][:, :2],
                                   atol=1.0 + 0.5 * px, rtol=0)
    assert n >= 4, n


def test_quantized_flavor_rules(monkeypatch):
    """The flavors are constructor arguments, default to the card and raise
    without one; no module of the port (models/quantize.py included)
    imports the JAX package; K3's wrapper refuses an int8 pyramid off the
    CPU and the card alike, before any launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FasterRCNN(FASTER_RCNN_TINY, dtype=torch.bfloat16,
                   roi_patch_quant=True, trunk_quant="folded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseHighResolutionNet(HRNET_TINY, dtype=torch.bfloat16, folded=True)
    path = ROOT / "stlpose_tpu_torch" / "models" / "quantize.py"
    banned = {"jax", "jaxlib", "flax", "stlpose_tpu"}
    assert path.exists() and not set(_imported_roots(path)) & banned
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        _k3.roi_align([torch.empty((1, 8, 8, 4), dtype=torch.int8,
                                   device=meta)],
                      torch.empty((1, 5, 4), device=meta),
                      torch.empty((1, 5), dtype=torch.int32, device=meta),
                      (4,), torch.empty((1, 4), device=meta), torch.bfloat16)
    assert _k3.LAUNCHES == 0 and not any(_k3.LAUNCHES_BY_TYPE.values())
