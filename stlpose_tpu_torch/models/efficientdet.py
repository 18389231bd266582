"""EfficientDet person detector (EfficientNet + BiFPN, one stage).

Port of ``stlpose_tpu/models/efficientdet.py`` (``SeparableConv``,
``BiFPNLayer``, ``HeadNet``, ``EfficientDetModule``,
``generate_det_anchors``, ``_focal_loss`` and the ``EfficientDet``
facade). One nn.Module holds the network and the facade's ``loss_fn``
and ``predict``, the protocol of the port's ``FasterRCNN``, so
``parallel/detector_steps.py``, the detector engines and the fused
two-stage program take either family. ``predict`` keeps the reference's
static shapes, batched over images where the reference vmaps: top-k of
the best class score, box decoding, greedy NMS of the first
``detections_per_img`` survivors on the K5 kernel (``ops/nms.py``), and
a final top-k into the padded {boxes, scores, labels, valid} format.

Inside, maps are NCHW; the heads' outputs are permuted to NHWC before
they are flattened to (N, H*W*A, k), so the anchor order is the
reference's (position-major, then octave, then ratio). Submodule and
parameter names repeat the Flax tree (``backbone``, ``bifpn_{l}`` with
its fusion weights ``w_td_{i}`` / ``w_bu_{i}``, ``classifier``,
``regressor``; the heads' per-level BatchNorms ``bn{r}_{level}``).

``dtype=torch.bfloat16`` is the bf16 flavor, as the reference's
``EfficientDet(dtype=bfloat16)``: convolutions in bf16, BatchNorm, swish
and the fast-attention fusion in f32, each layer's output cast back to
bf16; the heads return bf16 and box decoding promotes to f32. Serving
stores the convolutions in bf16; ``param_dtype=torch.float32`` keeps them
as f32 masters, cast at each call (bf16 training: both loss terms and
their sum in f32, as the reference's f32 targets promote them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import EFFICIENTDET_D0, EfficientDetConfig
from stlpose_tpu_torch.models.efficientnet import (Conv2d, EfficientNet, bn,
                                                   max_pool_same)
from stlpose_tpu_torch.models.faster_rcnn import bce_logits, gather_rows
from stlpose_tpu_torch.models.hrnet import compute_in
from stlpose_tpu_torch.ops.boxes import (box_iou, clip_boxes, decode_boxes,
                                         encode_boxes, smooth_l1)
from stlpose_tpu_torch.ops.nms import box_nms_topk, top_k

PRIOR_BIAS = -4.59          # the classifier's prior-probability bias
LEVELS = 5                  # P3-P7


class SeparableConv(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1."""

    def __init__(self, cin: int, features: int, bias_value: float = 0.0):
        super().__init__()
        self.dw = Conv2d(cin, cin, 3, groups=cin, bias=False)
        self.pw = Conv2d(cin, features, 1)
        with torch.no_grad():
            self.pw.bias.fill_(bias_value)

    def forward(self, x):
        return self.pw(self.dw(x))


def _up(x, like):
    """Nearest x2, cropped to ``like``'s extent."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :like.shape[2], :like.shape[3]]


def _down(x, like):
    """SAME-padded 3x3/2 max pool, cropped to ``like``'s extent."""
    return max_pool_same(x)[:, :, :like.shape[2], :like.shape[3]]


class BiFPNLayer(nn.Module):
    """One bidirectional FPN pass with fast-attention weighted fusion. A
    ``first_time`` layer takes the backbone's (C3, C4, C5) with their
    channel counts ``in_channels`` and owns the down-channel projections:
    conv+BN laterals for P3-P5, a conv+BN+pool P5 -> P6, a pooled P6 ->
    P7, and a second set of C4/C5 down-channels (``dc4b``, ``dc5b``) that
    feed the bottom-up residuals."""

    def __init__(self, channels: int, first_time: bool = False,
                 in_channels=None):
        super().__init__()
        self.first_time = first_time
        L = LEVELS
        if first_time:
            c3, c4, c5 = in_channels
            for name, cin in (("dc3", c3), ("dc4", c4), ("dc5", c5),
                              ("dc6", c5), ("dc4b", c4), ("dc5b", c5)):
                self.add_module(f"{name}_conv", Conv2d(cin, channels, 1))
                self.add_module(f"{name}_bn", bn(channels))
        for i in range(L - 2, -1, -1):
            self.register_parameter(f"w_td_{i}",
                                    nn.Parameter(torch.ones(2)))
            self.add_module(f"conv_td_{i}", SeparableConv(channels, channels))
            self.add_module(f"bn_td_{i}", bn(channels))
        for i in range(1, L):
            self.register_parameter(f"w_bu_{i}", nn.Parameter(
                torch.ones(2 if i == L - 1 else 3)))
            self.add_module(f"conv_bu_{i}", SeparableConv(channels, channels))
            self.add_module(f"bn_bu_{i}", bn(channels))

    def _fuse(self, inputs, name):
        """ReLU of the weights over their sum + 1e-4, applied in the
        weights' dtype (f32) and added in order, starting from 0 (Python's
        ``sum``)."""
        w = F.relu(getattr(self, name))
        w = w / (w.sum() + 1e-4)
        return sum(wi * x.to(w.dtype) for wi, x in zip(w, inputs))

    def _conv_bn(self, conv, norm, x):
        """A convolution, then its BatchNorm (f32), rounded back to the
        convolution's output dtype."""
        h = getattr(self, conv)(x)
        return getattr(self, norm)(h).to(h.dtype)

    def _down_channel(self, name, x):
        return self._conv_bn(f"{name}_conv", f"{name}_bn", x)

    def forward(self, feats):
        if self.first_time:
            c3, c4, c5 = feats
            p3 = self._down_channel("dc3", c3)
            p4 = self._down_channel("dc4", c4)
            p5 = self._down_channel("dc5", c5)
            p6 = max_pool_same(self._down_channel("dc6", c5))
            p7 = max_pool_same(p6)
            feats = [p3, p4, p5, p6, p7]
            residual = [p3, self._down_channel("dc4b", c4),
                        self._down_channel("dc5b", c5), p6, p7]
        else:
            residual = feats
        L = LEVELS
        td = [None] * L
        td[L - 1] = feats[L - 1]
        for i in range(L - 2, -1, -1):
            fused = self._fuse([feats[i], _up(td[i + 1], feats[i])],
                               f"w_td_{i}")
            td[i] = self._conv_bn(f"conv_td_{i}", f"bn_td_{i}",
                                  F.silu(fused))
        out = [None] * L
        out[0] = td[0]
        for i in range(1, L):
            ins = [residual[i], td[i], _down(out[i - 1], feats[i])]
            if i == L - 1:
                ins = [residual[i], _down(out[i - 1], feats[i])]
            fused = self._fuse(ins, f"w_bu_{i}")
            out[i] = self._conv_bn(f"conv_bu_{i}", f"bn_bu_{i}",
                                   F.silu(fused))
        return out


class HeadNet(nn.Module):
    """Separable convolutions shared across levels, a BatchNorm per
    (repeat, level), and the header (its bias holds the prior)."""

    def __init__(self, out_per_anchor: int, num_anchors: int, repeats: int,
                 channels: int, bias_value: float = 0.0):
        super().__init__()
        self.out_per_anchor = out_per_anchor
        self.repeats = repeats
        for r in range(repeats):
            self.add_module(f"conv{r}", SeparableConv(channels, channels))
            for li in range(LEVELS):
                self.add_module(f"bn{r}_{li}", bn(channels))
        self.head = SeparableConv(channels, num_anchors * out_per_anchor,
                                  bias_value)

    def forward(self, feats):
        outs = []
        for li, x in enumerate(feats):
            for r in range(self.repeats):
                x = getattr(self, f"conv{r}")(x)
                x = F.silu(getattr(self, f"bn{r}_{li}")(x)).to(x.dtype)
            y = self.head(x).permute(0, 2, 3, 1)            # NHWC
            outs.append(y.reshape(y.shape[0], -1, self.out_per_anchor))
        return torch.cat(outs, dim=1)


def generate_det_anchors(cfg: EfficientDetConfig, level_shapes):
    """Static multi-octave anchor grid, concatenated (A_total, 4) xyxy
    (numpy f32, the reference's arithmetic)."""
    out = []
    for (h, w), stride in zip(level_shapes, cfg.strides):
        base = []
        for octave in cfg.anchor_octaves:
            size = cfg.anchor_scale * stride * (2 ** octave)
            for rw, rh in cfg.anchor_ratios:
                bw = size * rw
                bh = size * rh
                base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)
        ys = (np.arange(h) + 0.5) * stride
        xs = (np.arange(w) + 0.5) * stride
        cx, cy = np.meshgrid(xs, ys)
        shifts = np.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        out.append((shifts + base[None]).reshape(-1, 4).astype(np.float32))
    return np.concatenate(out)


def focal_loss(logits, targets, alpha: float, gamma: float):
    """Sigmoid focal loss, elementwise."""
    p = torch.sigmoid(logits)
    ce = bce_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def one_hot(labels, n: int):
    """``jax.nn.one_hot``: a zero row for a label outside [0, n) (-1, an
    anchor matched to a padding box), where ``F.one_hot`` raises."""
    return (labels[..., None] ==
            torch.arange(n, device=labels.device)).to(torch.float32)


class EfficientDet(nn.Module):
    """Backbone + BiFPN + class and box heads, the training loss
    ``loss_fn`` and the inference program ``predict``. Built in eval
    mode, on ``device``; ``dtype`` (float32 or bfloat16) is the compute
    dtype, ``param_dtype`` the storage of the convolutions (None:
    ``dtype``; float32 for bf16 training). ``loss_fn`` puts the module in
    train mode and ``predict`` back in eval mode, each only when it is not
    already in it; training needs f32 weights."""

    def __init__(self, config: EfficientDetConfig = EFFICIENTDET_D0,
                 device="cuda", dtype=torch.float32, param_dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.dtype = dtype
        self.backbone = EfficientNet(cfg.width_mult, cfg.depth_mult)
        for i in range(cfg.fpn_repeats):
            self.add_module(f"bifpn_{i}", BiFPNLayer(
                cfg.fpn_channels, first_time=i == 0,
                in_channels=self.backbone.out_channels))
        n_anchors = len(cfg.anchor_ratios) * len(cfg.anchor_octaves)
        self.classifier = HeadNet(cfg.num_classes, n_anchors,
                                  cfg.head_repeats, cfg.fpn_channels,
                                  bias_value=PRIOR_BIAS)
        self.regressor = HeadNet(4, n_anchors, cfg.head_repeats,
                                 cfg.fpn_channels)
        self._anchors = {}
        compute_in(self.to(device), dtype, param_dtype)
        self.eval()

    def forward(self, images):
        """images (B, S, S, 3) in [0, 1] -> (class logits (B, A, classes),
        box deltas (B, A, 4), P3-P7 level shapes)."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        for i in range(self.config.fpn_repeats):
            feats = getattr(self, f"bifpn_{i}")(feats)
        shapes = [tuple(f.shape[2:]) for f in feats]
        return self.classifier(feats), self.regressor(feats), shapes

    def _get_anchors(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                generate_det_anchors(self.config, shapes)).to(device)
        return self._anchors[key]

    def loss_fn(self, batch, generator=None, uniforms=None, rows=None):
        """Total loss and loss dict for a batch {image (B, S, S, 3) in [0,
        1], boxes (B, K, 4), labels (B, K), box_mask (B, K)} of tensors on
        the model's device: focal classification and smooth-L1 box
        regression (beta 0.11), each divided by the image's positive
        count (at least 1), then the mean over images. BatchNorm on batch
        statistics, running statistics updated in place. Nothing is
        sampled: ``generator``, ``uniforms`` and ``rows`` are taken for
        the detector protocol and not used."""
        if not self.training:
            self.train()
        cfg = self.config
        cls, reg, shapes = self(batch["image"])
        anchors = self._get_anchors(shapes, cls.device)
        gt_boxes, gt_mask = batch["boxes"], batch["box_mask"]
        iou = box_iou(anchors, gt_boxes)                    # (B, A, G)
        iou = torch.where(gt_mask[:, None, :] > 0, iou, -1.0)
        best = iou.amax(-1)
        matched = iou.argmax(-1)
        pos = best >= cfg.fg_iou
        valid = pos | (best < cfg.bg_iou)
        # one-hot class targets (person = class 0 of the sigmoid head)
        labels = torch.gather(batch["labels"], 1, matched) - 1
        tgt = one_hot(labels, cfg.num_classes) * pos[..., None]
        fl = focal_loss(cls, tgt, cfg.focal_alpha, cfg.focal_gamma)
        n_pos = torch.clamp(pos.sum(-1), min=1)
        loss_cls = torch.where(valid[..., None], fl, 0.0).sum((1, 2)) / n_pos
        deltas = encode_boxes(gather_rows(gt_boxes, matched), anchors)
        lb = smooth_l1(reg, deltas, beta=0.11).sum(-1)
        loss_box = torch.where(pos, lb, 0.0).sum(-1) / n_pos
        loss_dict = {"loss_classifier": loss_cls.mean(),
                     "loss_box_reg": loss_box.mean()}
        return loss_dict["loss_classifier"] + loss_dict["loss_box_reg"], \
            loss_dict

    @torch.inference_mode()
    def predict(self, images):
        """images (B, S, S, 3) float in [0, 1] -> {boxes (B, D, 4) f32,
        scores (B, D) in the compute dtype, labels (B, D) int32 (person =
        1), valid (B, D)}, padded to ``detections_per_img``. Eval-mode
        BatchNorm, also right after a train step."""
        if self.training:
            self.eval()
        cfg = self.config
        cls, reg, shapes = self(images)
        anchors = self._get_anchors(shapes, cls.device)
        scores_all = torch.sigmoid(cls)                     # (B, A, C)
        best_s, best_c = scores_all.max(dim=-1)
        top_s, top_i = top_k(best_s, cfg.pre_nms_top_n)
        boxes = clip_boxes(decode_boxes(gather_rows(reg, top_i),
                                        anchors[top_i]),
                           (cfg.image_size, cfg.image_size))
        ok = top_s > cfg.score_thresh
        keep = box_nms_topk(boxes, torch.where(ok, top_s, -torch.inf),
                            cfg.nms_thresh, ok, cfg.detections_per_img)
        sc = torch.where(keep & ok, top_s, -torch.inf)
        out_s, oi = top_k(sc, cfg.detections_per_img)
        labels = torch.gather(torch.gather(best_c, 1, top_i), 1, oi) + 1
        return {"boxes": gather_rows(boxes, oi),
                "scores": torch.clamp(out_s, min=0.0),
                "labels": labels.to(torch.int32),
                "valid": out_s > -torch.inf}
