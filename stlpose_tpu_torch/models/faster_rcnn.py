"""Faster R-CNN (ResNet-FPN) person detector: training loss and inference.

Port of ``stlpose_tpu/models/faster_rcnn.py`` (FPN, RPNHead, BoxHead,
FasterRCNNModule with ``roi_batched``, generate_anchors,
select_proposals, the target matching and rank-mask sampling, the RPN and
RoI losses, FasterRCNN.loss_fn and FasterRCNN.predict). One nn.Module
holds the trunk and the facade's ``loss_fn`` and ``predict``. Every stage
keeps the reference's static shapes: per-level top-k, pick-argmax NMS
with ``max_keep`` picks, fixed-size top-k, all batched over images, where
the reference vmaps its per-image function. RoIAlign runs in the K3
kernel; under ``loss_fn`` its gradient runs in K3b.

Random draws: ``sample_balanced`` draws two uniforms per candidate, from
an explicit ``torch.Generator`` or handed in by the caller (the tests hand
it the JAX package's draws, so the sampling is the same, not just the
same in distribution).

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
from stlpose_tpu_torch.ops.boxes import (box_iou, clip_boxes, decode_boxes,
                                         encode_boxes, smooth_l1)
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


def gather_rows(x, idx):
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _rank_desc(values):
    """rank[..., i] = position of element i in the stable descending sort
    of the last axis (``jnp.argsort`` is stable)."""
    order = torch.argsort(-values, dim=-1, stable=True)
    ar = torch.arange(values.shape[-1], device=values.device)
    return torch.empty_like(order).scatter_(-1, order, ar.expand_as(order))


def sample_balanced(labels, batch_size: int, positive_fraction: float,
                    uniforms=None, generator=None):
    """Rank-mask minibatch sampling over the last axis: up to
    batch*fraction positives, negatives fill the remainder. labels: 1
    positive, 0 negative, -1 ignored. ``uniforms``: the two draws (u1, u2),
    each of labels' shape in [0, 1), or None to draw them from
    ``generator``. Returns (pos_mask, neg_mask)."""
    if uniforms is None:
        uniforms = [torch.rand(labels.shape, generator=generator,
                               device=labels.device) for _ in range(2)]
    u1, u2 = uniforms
    pos = labels == 1
    neg = labels == 0
    max_pos = int(batch_size * positive_fraction)
    pos_sel = pos & (_rank_desc(torch.where(pos, u1, -1.0)) < max_pos)
    n_pos = pos_sel.sum(-1, keepdim=True)
    neg_sel = neg & (_rank_desc(torch.where(neg, u2, -1.0)) <
                     batch_size - n_pos)
    return pos_sel, neg_sel


def match_to_gt(anchors, gt_boxes, gt_mask, fg_iou, bg_iou,
                force_best_per_gt: bool = True):
    """IoU matching of anchors (A, 4) or (B, A, 4) to GT boxes (B, G, 4)
    -> (labels {1, 0, -1}, matched GT index), each (B, A).

    Padded GT rows (gt_mask 0) never match. Anchors with IoU >= fg_iou are
    positive, < bg_iou negative, between ignored; optionally the best
    anchor for each GT is forced positive (the RPN rule)."""
    iou = box_iou(anchors, gt_boxes)                        # (B, A, G)
    iou = torch.where(gt_mask[:, None, :] > 0, iou, -1.0)
    best_iou = iou.amax(-1)
    matched = iou.argmax(-1)
    labels = torch.where(best_iou >= fg_iou, 1,
                         torch.where(best_iou < bg_iou, 0, -1))
    if force_best_per_gt:
        per_gt_best = iou.amax(-2, keepdim=True)            # (B, 1, G)
        force = (iou >= per_gt_best - 1e-6) & \
            (gt_mask[:, None, :] > 0) & (per_gt_best > 0)
        labels = torch.where(force.any(-1), 1, labels)
    return labels, matched


def select_proposals(cfg, anchors_per_level, logits, deltas,
                     train: bool = False):
    """Static-shape proposals for a batch, at the train or the test-time
    budgets.

    logits: per level (B, h*w*A); deltas: per level (B, h*w*A, 4).
    Returns (B, P, 4) boxes and (B, P) scores, P = post_nms_top_n."""
    pre_n = cfg.pre_nms_top_n_train if train else cfg.pre_nms_top_n_test
    post_n = cfg.post_nms_top_n_train if train else cfg.post_nms_top_n_test
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


def bce_logits(logits, targets):
    """Binary cross-entropy of sigmoid ``logits``, elementwise, in the
    stable form max(x, 0) - x t + log(1 + exp(-|x|))."""
    return torch.clamp(logits, min=0.0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def rpn_loss(cfg, anchors, logits_flat, deltas_flat, gt_boxes, gt_mask,
             uniforms=None, generator=None):
    """RPN objectness and box regression, per image: logits (B, A),
    deltas (B, A, 4) over the anchors (A, 4); GT boxes (B, G, 4) and mask
    (B, G); ``uniforms`` the sampling's (u1, u2), each (B, A). Returns
    ((B,), (B,))."""
    labels, matched = match_to_gt(anchors, gt_boxes, gt_mask,
                                  cfg.rpn_fg_iou, cfg.rpn_bg_iou)
    no_gt = (gt_mask.sum(-1) == 0)[:, None]
    labels = torch.where(no_gt, torch.where(labels == -1, -1, 0), labels)
    pos_sel, neg_sel = sample_balanced(labels, cfg.rpn_batch_per_image,
                                       cfg.rpn_positive_fraction, uniforms,
                                       generator)
    sampled = pos_sel | neg_sel
    n_sampled = torch.clamp(sampled.sum(-1), min=1)

    obj = bce_logits(logits_flat, pos_sel.to(logits_flat.dtype))
    loss_obj = torch.where(sampled, obj, 0.0).sum(-1) / n_sampled

    target_deltas = encode_boxes(gather_rows(gt_boxes, matched), anchors)
    reg = smooth_l1(deltas_flat, target_deltas).sum(-1)
    loss_reg = torch.where(pos_sel, reg, 0.0).sum(-1) / n_sampled
    return loss_obj, loss_reg


def roi_targets(cfg, proposals, gt_boxes, gt_labels, gt_mask, uniforms=None,
                generator=None):
    """Match proposals (B, P, 4) to GT and sample the RoI minibatch, per
    image; GT boxes join the proposal pool first (torchvision's rule).
    ``uniforms``: the sampling's (u1, u2), each (B, P + G). Returns boxes
    (B, R, 4), labels (B, R), reg_targets (B, R, 4), pos_mask and
    sampled_mask (B, R), R = roi_batch_per_image."""
    pool = torch.cat([proposals, gt_boxes], dim=1)
    iou = box_iou(pool, gt_boxes)
    iou = torch.where(gt_mask[:, None, :] > 0, iou, -1.0)
    best = iou.amax(-1)
    matched = iou.argmax(-1)
    is_pos = best >= cfg.roi_fg_iou
    labels = torch.where(is_pos, torch.gather(gt_labels, 1, matched), 0)
    pos_sel, neg_sel = sample_balanced(
        is_pos.to(torch.int64), cfg.roi_batch_per_image,
        cfg.roi_positive_fraction, uniforms, generator)
    sampled = pos_sel | neg_sel
    # compact the sampled rows to a fixed R by a ranked top-k
    priority = sampled.to(torch.float32) * 2 + pos_sel.to(torch.float32)
    _, idx = top_k(priority + best * 1e-3, cfg.roi_batch_per_image)
    boxes = gather_rows(pool, idx)
    sampled_r = torch.gather(sampled, 1, idx)
    out_labels = torch.where(sampled_r, torch.gather(labels, 1, idx), 0)
    reg_targets = encode_boxes(
        gather_rows(gt_boxes, torch.gather(matched, 1, idx)), boxes,
        cfg.box_weights)
    return (boxes, out_labels, reg_targets, torch.gather(pos_sel, 1, idx),
            sampled_r)


def roi_loss(cfg, cls_logits, box_deltas, labels, reg_targets, pos_mask,
             sampled_mask):
    """Box-head classification and class-specific regression, per image:
    logits (B, R, classes), deltas (B, R, 4 * classes). Returns ((B,),
    (B,))."""
    n = torch.clamp(sampled_mask.sum(-1), min=1)
    logp = F.log_softmax(cls_logits, dim=-1)
    lab = labels.to(torch.int64)
    ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
    loss_cls = torch.where(sampled_mask, ce, 0.0).sum(-1) / n

    deltas = box_deltas.reshape(*box_deltas.shape[:2], cfg.num_classes, 4)
    picked = torch.gather(deltas, 2, lab[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    reg = smooth_l1(picked, reg_targets, beta=1.0).sum(-1)
    n_pos = torch.clamp(pos_mask.sum(-1), min=1)
    loss_reg = torch.where(pos_mask, reg, 0.0).sum(-1) / n_pos
    return loss_cls, loss_reg


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN head + box head, the training loss ``loss_fn``
    and the inference program ``predict``. Built in eval mode, on
    ``device``; ``dtype`` (float32 or bfloat16) is the compute dtype;
    ``roi_patch_quant`` pools RoIs from the int8 patch pyramid;
    ``trunk_quant`` is "none" (live BatchNorm) or "folded". ``loss_fn``
    puts the module in train mode and ``predict`` back in eval mode, each
    only when it is not already in it; training needs the live trunk in
    f32."""

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

    def _rpn(self, images):
        """Trunk, FPN and RPN head on (B, S, S, 3) images: (P2..P6 NCHW,
        per-level logits (B, h*w*A), per-level deltas (B, h*w*A, 4),
        per-level anchors)."""
        feats = self.features(images.permute(0, 3, 1, 2).contiguous())
        logits, deltas = self.rpn_head(feats)
        B = images.shape[0]
        shapes = [tuple(l.shape[2:]) for l in logits]
        anchors = self._get_anchors(shapes, images.device)
        logits = [l.permute(0, 2, 3, 1).reshape(B, -1) for l in logits]
        deltas = [d.permute(0, 2, 3, 1).reshape(B, -1, 4) for d in deltas]
        return feats, logits, deltas, anchors

    def loss_fn(self, batch, generator=None, uniforms=None):
        """Total loss and loss dict for a batch {image (B, S, S, 3) in [0,
        1], boxes (B, K, 4), labels (B, K), box_mask (B, K)} of tensors on
        the model's device: the torchvision loss dict that the reference
        sums, each term the mean over images. Runs the trunk in train mode
        (BatchNorm on batch statistics, running statistics updated in
        place). ``generator`` draws the sampling's uniforms; ``uniforms``
        hands them in instead: {"rpn": (u1, u2) each (B, A), "roi": (u1,
        u2) each (B, post_nms_top_n_train + K)}."""
        if self.trunk_quant != "none":
            raise ValueError(
                "training requires the live-BN trunk; construct "
                "FasterRCNN(trunk_quant='none') for loss_fn "
                f"(got trunk_quant={self.trunk_quant!r})")
        if not self.training:
            self.train()
        cfg = self.config
        uniforms = uniforms or {}
        gt_boxes, gt_labels = batch["boxes"], batch["labels"]
        gt_mask = batch["box_mask"]
        feats, logits, deltas, anchors_l = self._rpn(batch["image"])
        l_obj, l_rpn = rpn_loss(cfg, torch.cat(anchors_l),
                                torch.cat(logits, dim=1),
                                torch.cat(deltas, dim=1), gt_boxes, gt_mask,
                                uniforms.get("rpn"), generator)
        with torch.no_grad():       # the proposals are constants of the loss
            props, _ = select_proposals(cfg, anchors_l,
                                        [l.detach() for l in logits],
                                        [d.detach() for d in deltas],
                                        train=True)
            boxes, labels, regs, pos, sampled = roi_targets(
                cfg, props, gt_boxes, gt_labels, gt_mask,
                uniforms.get("roi"), generator)
        cls_logits, box_deltas = self.roi_batched(feats[:4], boxes)
        l_cls, l_box = roi_loss(cfg, cls_logits, box_deltas, labels, regs,
                                pos, sampled)
        loss_dict = {"loss_objectness": l_obj.mean(),
                     "loss_rpn_box_reg": l_rpn.mean(),
                     "loss_classifier": l_cls.mean(),
                     "loss_box_reg": l_box.mean()}
        total = (loss_dict["loss_objectness"] + loss_dict["loss_rpn_box_reg"]
                 + loss_dict["loss_classifier"] + loss_dict["loss_box_reg"])
        return total, loss_dict

    @torch.inference_mode()
    def predict(self, images):
        """images (B, S, S, 3) float in [0, 1] -> {boxes (B, D, 4) f32,
        scores (B, D) in the compute dtype, labels (B, D), valid (B, D)},
        padded to ``detections_per_img``. Eval-mode BatchNorm, also right
        after a train step."""
        if self.training:
            self.eval()
        cfg = self.config
        feats, logits, deltas, anchors = self._rpn(images)
        B = images.shape[0]
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
