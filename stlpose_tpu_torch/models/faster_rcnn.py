"""Faster R-CNN (ResNet-FPN) person detector, inference only.

Port of ``stlpose_tpu/models/faster_rcnn.py`` (FPN, RPNHead, BoxHead,
FasterRCNNModule with ``roi_batched``, generate_anchors,
select_proposals, FasterRCNN.predict). One nn.Module holds the trunk and
the facade's ``predict``. Every stage keeps the reference's static shapes:
per-level top-k, pick-argmax NMS with ``max_keep`` picks, fixed-size
top-k, all batched over images. RoIAlign runs in the K3 kernel.

Serving flavors, as constructor arguments (no environment switch):
``dtype=torch.bfloat16`` runs the convolutions and dense layers in bf16
and follows the JAX package's bf16 ``predict`` op by op (RPN logits and
box-head outputs stay bf16 into top-k, softmax and the score tests; box
decoding promotes to f32 at its first f32 operand); ``roi_patch_quant``
pools from the int8 patch pyramid; ``trunk_quant="folded"`` takes a trunk
with BatchNorm folded into its convolutions
(``models/quantize.py::fold_frcnn_trunk``).

Submodule names repeat the Flax module tree (``backbone``, ``fpn``,
``rpn_head``, ``box_head``). ``BoxHead`` flattens the pooled features in
(7, 7, C) order, as the reference does, so ``fc6`` carries across with a
plain transpose.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import FasterRCNNConfig
from stlpose_tpu_torch.models.hrnet import compute_in
from stlpose_tpu_torch.models.quantize import check_trunk_flavor
from stlpose_tpu_torch.models.resnet import ResNet
from stlpose_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from stlpose_tpu_torch.ops.nms import box_nms_topk, top_k
from stlpose_tpu_torch.ops.roi_align import multilevel_roi_align


class FPN(nn.Module):
    """C2..C5 -> P2..P5 (+ P6 by stride-2 subsampling), top-down path."""

    def __init__(self, in_channels, channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(cin, channels, 1))
            self.add_module(f"out{i}", nn.Conv2d(channels, channels, 3, 1, 1))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        outs = [laterals[-1]]
        for i in range(self.n - 2, -1, -1):
            th, tw = laterals[i].shape[2:]
            # 2x nearest broadcast cropped to the lateral's size (at odd
            # sizes F.interpolate(size=...) would pick other source rows)
            up = outs[0].repeat_interleave(2, dim=2) \
                .repeat_interleave(2, dim=3)[:, :, :th, :tw]
            outs.insert(0, laterals[i] + up)
        ps = [getattr(self, f"out{i}")(o) for i, o in enumerate(outs)]
        return ps + [F.max_pool2d(ps[-1], 1, 2)]


class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1)
        self.cls = nn.Conv2d(channels, num_anchors, 1)
        self.reg = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.cls(t))
            deltas.append(self.reg(t))
        return logits, deltas


class BoxHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.fc6 = nn.Linear(in_features, 1024)
        self.fc7 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, num_classes)
        self.bbox_pred = nn.Linear(1024, num_classes * 4)

    def forward(self, roi_feats):
        """roi_feats (N, 7, 7, C), flattened in that order."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        return self.cls_score(x), self.bbox_pred(x)


def generate_anchors(cfg: FasterRCNNConfig, level_shapes):
    """Static anchor grid per level, (h*w*A, 4) xyxy each, in (h, w, a)
    order (numpy f32, the reference's arithmetic)."""
    all_anchors = []
    for (h, w), stride, size in zip(level_shapes, cfg.strides,
                                    cfg.anchor_sizes):
        base = []
        for ratio in cfg.anchor_ratios:
            bw = size * np.sqrt(1.0 / ratio)
            bh = size * np.sqrt(ratio)
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)
        ys = np.arange(h, dtype=np.float32) * stride
        xs = np.arange(w, dtype=np.float32) * stride
        cx, cy = np.meshgrid(xs, ys)
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        all_anchors.append((shifts + base[None]).reshape(-1, 4))
    return all_anchors


def softmax(x):
    """``jax.nn.softmax`` over the last axis, op by op in the input's
    dtype: exp(x - max), summed in f32 and rounded back, then divided."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.float().sum(dim=-1, keepdim=True).to(e.dtype)


def select_proposals(cfg, anchors_per_level, logits, deltas):
    """Static-shape proposals for a batch (test-time budgets).

    logits: per level (B, h*w*A); deltas: per level (B, h*w*A, 4).
    Returns (B, P, 4) boxes and (B, P) scores, P = post_nms_top_n_test."""
    pre_n, post_n = cfg.pre_nms_top_n_test, cfg.post_nms_top_n_test
    cand_boxes, cand_scores, cand_levels = [], [], []
    for li, (anch, s, d) in enumerate(zip(anchors_per_level, logits,
                                          deltas)):
        k = min(pre_n, s.shape[1])
        top_s, top_i = top_k(s, k)                                # (B, k)
        dd = torch.gather(d, 1, top_i[..., None].expand(-1, -1, 4))
        boxes = clip_boxes(decode_boxes(dd, anch[top_i]),
                           (cfg.image_size, cfg.image_size))
        cand_boxes.append(boxes)
        cand_scores.append(top_s)
        cand_levels.append(torch.full((k,), float(li), device=s.device))
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    levels = torch.cat(cand_levels)

    wh_ok = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & \
        ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
    # per-level NMS: offset boxes by level so levels never suppress each
    # other (torchvision's batched_nms trick)
    offset = levels[None, :, None] * (cfg.image_size * 2.0)
    keep = box_nms_topk(boxes + offset,
                        torch.where(wh_ok, scores, -torch.inf),
                        cfg.rpn_nms_thresh, wh_ok, post_n)
    top_s, top_i = top_k(torch.where(keep, scores, -torch.inf), post_n)
    return torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)), top_s


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN head + box head, and the inference program
    ``predict``. Eval mode, on ``device``; ``dtype`` (float32 or
    bfloat16) is the compute dtype; ``roi_patch_quant`` pools RoIs from
    the int8 patch pyramid; ``trunk_quant`` is "none" (live BatchNorm) or
    "folded"."""

    def __init__(self, config: FasterRCNNConfig = FasterRCNNConfig(),
                 device="cuda", dtype=torch.float32,
                 roi_patch_quant: bool = False, trunk_quant: str = "none"):
        super().__init__()
        check_trunk_flavor(trunk_quant)
        device = resolve_device(device)
        self.config = cfg = config
        self.dtype = dtype
        self.roi_patch_quant = roi_patch_quant
        self.trunk_quant = trunk_quant
        self.backbone = ResNet(cfg.stage_sizes, cfg.width,
                               folded=trunk_quant == "folded")
        c2 = cfg.width * 4
        self.fpn = FPN([c2, c2 * 2, c2 * 4, c2 * 8], cfg.fpn_channels)
        self.rpn_head = RPNHead(cfg.fpn_channels, len(cfg.anchor_ratios))
        self.box_head = BoxHead(7 * 7 * cfg.fpn_channels, cfg.num_classes)
        self._anchors = {}
        compute_in(self.to(device), dtype)
        self.eval()

    def features(self, images_nchw):
        return self.fpn(self.backbone(images_nchw))

    def roi_batched(self, feats, boxes):
        """feats: P2..P5 NCHW (B, C, h, w); boxes (B, P, 4). One RoIAlign
        over all B*P boxes, box head applied flat. Returns
        ((B, P, classes), (B, P, 4*classes))."""
        B, P = boxes.shape[:2]
        feats_nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in feats]
        pooled = multilevel_roi_align(feats_nhwc, boxes,
                                      self.config.strides[:len(feats)],
                                      self.roi_patch_quant)
        cls, reg = self.box_head(pooled.reshape(B * P, *pooled.shape[2:]))
        return cls.reshape(B, P, -1), reg.reshape(B, P, -1)

    def _get_anchors(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = [torch.from_numpy(a).to(device) for a in
                                  generate_anchors(self.config, shapes)]
        return self._anchors[key]

    @torch.inference_mode()
    def predict(self, images):
        """images (B, S, S, 3) float in [0, 1] -> {boxes (B, D, 4) f32,
        scores (B, D) in the compute dtype, labels (B, D), valid (B, D)},
        padded to ``detections_per_img``."""
        cfg = self.config
        feats = self.features(images.permute(0, 3, 1, 2).contiguous())
        logits, deltas = self.rpn_head(feats)
        B = images.shape[0]
        shapes = [tuple(l.shape[2:]) for l in logits]
        anchors = self._get_anchors(shapes, images.device)
        logits = [l.permute(0, 2, 3, 1).reshape(B, -1) for l in logits]
        deltas = [d.permute(0, 2, 3, 1).reshape(B, -1, 4) for d in deltas]
        props, _ = select_proposals(cfg, anchors, logits, deltas)
        cls_b, deltas_b = self.roi_batched(feats[:4], props)

        scores = softmax(cls_b)
        nc = cfg.num_classes
        out_boxes, out_scores, out_labels = [], [], []
        for c in range(1, nc):
            d = deltas_b.reshape(B, -1, nc, 4)[:, :, c]
            boxes = clip_boxes(decode_boxes(d, props, cfg.box_weights),
                               (cfg.image_size, cfg.image_size))
            sc = scores[..., c]
            ok = sc > cfg.score_thresh
            keep = box_nms_topk(boxes, torch.where(ok, sc, -torch.inf),
                                cfg.nms_thresh, ok, cfg.detections_per_img)
            out_boxes.append(boxes)
            out_scores.append(torch.where(keep & ok, sc, -torch.inf))
            out_labels.append(torch.full(sc.shape, c, dtype=torch.int32,
                                         device=sc.device))
        boxes = torch.cat(out_boxes, dim=1)
        sc = torch.cat(out_scores, dim=1)
        lb = torch.cat(out_labels, dim=1)
        top_s, top_i = top_k(sc, cfg.detections_per_img)
        return {"boxes": torch.gather(boxes, 1,
                                      top_i[..., None].expand(-1, -1, 4)),
                "scores": torch.clamp(top_s, min=0.0),
                "labels": torch.gather(lb, 1, top_i),
                "valid": top_s > -torch.inf}
