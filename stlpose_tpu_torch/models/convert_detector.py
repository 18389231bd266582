"""Detector checkpoints of both reference families -> the port's models.

``torch_fasterrcnn_to_port``, counterpart of ``stlpose_tpu/models/
convert_detector.py::torch_fasterrcnn_to_flax``: a torchvision ``fasterrcnn_resnet50_fpn``
state dict (the reference fine-tunes torchvision's COCO-pretrained
detector and saves its checkpoints in that layout) in the port's names.
Both sides are torch modules, so convolution and dense layouts stay; only
names change, and ``fc6``'s input dimension, which torchvision flattens
from (C, 7, 7) and the port (as the reference) from (7, 7, C). Both the
old (``rpn.head.conv.weight``) and the new (``rpn.head.conv.0.0.weight``,
``fpn.inner_blocks.{i}.0.weight``) torchvision namings are accepted;
``num_batches_tracked`` is dropped. torchvision's FrozenBatchNorm2d
statistics map onto the trunk's BatchNorm unchanged.

``torch_efficientdet_to_port``, counterpart of ``torch_efficientdet_to_flax``:
a zylo117-layout EfficientDet state dict (``efficientdet-d{0,3}.pth``, the
format the reference loads through ``EfficientDetBackbone.init_backbone``)
in the port's ``EfficientDet`` names, layouts unchanged: the lukemelas
backbone (``backbone_net.model._blocks.{i}._depthwise_conv``, ...), the
BiFPN cells (``conv{p}_up`` / ``conv{p}_down`` -> ``conv_td_{p-3}`` /
``conv_bu_{p-3}``, ``p{p}_w1`` / ``p{p}_w2`` -> ``w_td_{p-3}`` /
``w_bu_{p-3}``, the first cell's down-channel stacks -> ``dc3``-``dc6``,
``dc4b``, ``dc5b``) and the heads (``bn_list.{level}.{layer}`` ->
``bn{layer}_{level}``). A classifier header with more classes than the
model's (the official checkpoints ship 90 COCO classes) is sliced to
``num_classes`` consecutive classes from ``person_class``, per anchor
(anchor-major channels), or dropped with ``person_class=None``.
"""

from __future__ import annotations

import re

import torch

_BN = {"weight": "weight", "bias": "bias", "running_mean": "running_mean",
       "running_var": "running_var"}


def _port_key(key: str):
    """The port's name of one torchvision key; None for
    ``num_batches_tracked``; KeyError for an unknown key."""
    if key.endswith("num_batches_tracked"):
        return None
    m = re.fullmatch(r"backbone\.body\.(conv1|bn1)\.(\w+)", key)
    if m:
        return ("backbone.stem_conv." if m.group(1) == "conv1"
                else "backbone.stem_bn.") + _BN[m.group(2)]
    m = re.fullmatch(r"backbone\.body\.layer(\d)\.(\d+)\.(conv|bn)(\d)\."
                     r"(\w+)", key)
    if m:
        s, b, kind, q, leaf = m.groups()
        return f"backbone.layer{s}_{b}.cb{q}.{kind}.{_BN[leaf]}"
    m = re.fullmatch(r"backbone\.body\.layer(\d)\.(\d+)\.downsample\."
                     r"([01])\.(\w+)", key)
    if m:
        s, b, idx, leaf = m.groups()
        return (f"backbone.layer{s}_{b}.down."
                f"{'conv' if idx == '0' else 'bn'}.{_BN[leaf]}")
    m = re.fullmatch(r"backbone\.fpn\.(inner|layer)_blocks\.(\d+)(?:\.0)?\."
                     r"(weight|bias)", key)
    if m:
        kind, i, leaf = m.groups()
        return f"fpn.{'lateral' if kind == 'inner' else 'out'}{i}.{leaf}"
    m = re.fullmatch(r"rpn\.head\.conv(?:\.0\.0)?\.(weight|bias)", key)
    if m:
        return f"rpn_head.conv.{m.group(1)}"
    m = re.fullmatch(r"rpn\.head\.(cls_logits|bbox_pred)\.(weight|bias)",
                     key)
    if m:
        which = "cls" if m.group(1) == "cls_logits" else "reg"
        return f"rpn_head.{which}.{m.group(2)}"
    m = re.fullmatch(r"roi_heads\.box_head\.(fc6|fc7)\.(weight|bias)", key)
    if m:
        return f"box_head.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"roi_heads\.box_predictor\.(cls_score|bbox_pred)\."
                     r"(weight|bias)", key)
    if m:
        return f"box_head.{m.group(1)}.{m.group(2)}"
    raise KeyError(f"Unrecognized detector state_dict key: {key}")


def torch_fasterrcnn_to_port(state, roi_channels: int = 256,
                             roi_size: int = 7) -> dict:
    """A torchvision fasterrcnn_resnet50_fpn state dict (tensors or numpy
    arrays) -> {port name: float32 tensor} for ``FasterRCNN`` (load it
    with ``models/convert.py::load_strict``)."""
    out = {}
    for key, val in state.items():
        name = _port_key(key)
        if name is None:
            continue
        t = torch.as_tensor(val).detach().to(torch.float32).cpu()
        if name == "box_head.fc6.weight":
            # (out, C*7*7) in (C, 7, 7) order -> (out, 7*7*C)
            n_out = t.shape[0]
            t = t.reshape(n_out, roi_channels, roi_size, roi_size) \
                .permute(0, 2, 3, 1).reshape(n_out, -1)
        out[name] = t.contiguous()
    return out


_EFFDET_BLOCK = {"expand_conv": "expand_conv", "depthwise_conv": "dw_conv",
                 "project_conv": "project_conv"}
_EFFDET_DC = {"p3_down_channel": "dc3", "p4_down_channel": "dc4",
              "p5_down_channel": "dc5", "p5_to_p6": "dc6",
              "p4_down_channel_2": "dc4b", "p5_down_channel_2": "dc5b"}
_SEP = {"depthwise_conv": "dw", "pointwise_conv": "pw"}


def _efficientdet_key(key: str):
    """The port's name of one zylo117 key; None for ``num_batches_tracked``
    and the ``anchors`` buffer; KeyError for an unknown key."""
    if key.endswith("num_batches_tracked") or key.startswith("anchors."):
        return None
    bb = r"backbone_net\.model\."
    if key == "backbone_net.model._conv_stem.weight":
        return "backbone.stem_conv.weight"
    m = re.fullmatch(bb + r"_bn0\.(\w+)", key)
    if m:
        return f"backbone.stem_bn.{_BN[m.group(1)]}"
    m = re.fullmatch(bb + r"_blocks\.(\d+)\._(expand_conv|depthwise_conv|"
                     r"project_conv)\.weight", key)
    if m:
        return f"backbone.block{m.group(1)}.{_EFFDET_BLOCK[m.group(2)]}.weight"
    m = re.fullmatch(bb + r"_blocks\.(\d+)\._(bn[012])\.(\w+)", key)
    if m:
        i, norm, leaf = m.groups()
        return f"backbone.block{i}.{norm}.{_BN[leaf]}"
    m = re.fullmatch(bb + r"_blocks\.(\d+)\._(se_reduce|se_expand)\."
                     r"(weight|bias)", key)
    if m:
        return "backbone.block{}.{}.{}".format(*m.groups())
    m = re.fullmatch(r"bifpn\.(\d+)\.conv(\d)_(up|down)\.(depthwise_conv|"
                     r"pointwise_conv)\.conv\.(weight|bias)", key)
    if m:
        cell, p, ud, part, leaf = m.groups()
        tag = "td" if ud == "up" else "bu"
        return f"bifpn_{cell}.conv_{tag}_{int(p) - 3}.{_SEP[part]}.{leaf}"
    m = re.fullmatch(r"bifpn\.(\d+)\.conv(\d)_(up|down)\.bn\.(\w+)", key)
    if m:
        cell, p, ud, leaf = m.groups()
        tag = "td" if ud == "up" else "bu"
        return f"bifpn_{cell}.bn_{tag}_{int(p) - 3}.{_BN[leaf]}"
    m = re.fullmatch(r"bifpn\.(\d+)\.p(\d)_w([12])", key)
    if m:
        cell, p, w = m.groups()
        return f"bifpn_{cell}.w_{'td' if w == '1' else 'bu'}_{int(p) - 3}"
    m = re.fullmatch(r"bifpn\.(\d+)\.(" + "|".join(_EFFDET_DC) +
                     r")\.([01])\.(?:conv\.)?(\w+)", key)
    if m:
        cell, which, idx, leaf = m.groups()
        part = "conv" if idx == "0" else "bn"
        return f"bifpn_{cell}.{_EFFDET_DC[which]}_{part}.{_BN[leaf]}"
    m = re.fullmatch(r"(regressor|classifier)\.conv_list\.(\d+)\."
                     r"(depthwise_conv|pointwise_conv)\.conv\.(weight|bias)",
                     key)
    if m:
        head, i, part, leaf = m.groups()
        return f"{head}.conv{i}.{_SEP[part]}.{leaf}"
    m = re.fullmatch(r"(regressor|classifier)\.bn_list\.(\d+)\.(\d+)\."
                     r"(\w+)", key)
    if m:
        head, level, layer, leaf = m.groups()
        return f"{head}.bn{layer}_{level}.{_BN[leaf]}"
    m = re.fullmatch(r"(regressor|classifier)\.header\.(depthwise_conv|"
                     r"pointwise_conv)\.conv\.(weight|bias)", key)
    if m:
        head, part, leaf = m.groups()
        return f"{head}.head.{_SEP[part]}.{leaf}"
    raise KeyError(f"Unrecognized EfficientDet state_dict key: {key}")


def torch_efficientdet_to_port(state, num_classes: int = 1,
                               person_class: int | None = 0) -> dict:
    """A zylo117-layout EfficientDet state dict (tensors or numpy arrays)
    -> {port name: float32 tensor} for ``EfficientDet`` (load it with
    ``models/convert.py::load_strict``). A multiclass classifier header
    is sliced to ``num_classes`` consecutive checkpoint classes from
    ``person_class``, per anchor; with ``person_class=None`` the
    classifier's header (depthwise and pointwise) is left out, so the
    caller keeps its own."""
    out = {}
    for key, val in state.items():
        name = _efficientdet_key(key)
        if name is not None:
            out[name] = torch.as_tensor(val).detach().to(torch.float32) \
                .cpu().contiguous()
    w_key, b_key = "classifier.head.pw.weight", "classifier.head.pw.bias"
    if b_key not in out:
        return out
    total = out[b_key].shape[0]
    # the regressor's header has 4 channels per anchor
    num_anchors = out["regressor.head.pw.bias"].shape[0] // 4
    ckpt_classes = total // num_anchors
    if ckpt_classes == num_classes:
        return out
    if person_class is None:
        for k in [k for k in out if k.startswith("classifier.head.")]:
            del out[k]
        return out
    if person_class + num_classes > ckpt_classes:
        raise ValueError(
            f"cannot slice {num_classes} classes starting at class "
            f"{person_class} out of a {ckpt_classes}-class checkpoint "
            f"header; pass person_class=None to drop the header")
    sel = (torch.arange(num_anchors)[:, None] * ckpt_classes + person_class
           + torch.arange(num_classes)[None, :]).reshape(-1)
    out[w_key] = out[w_key][sel].contiguous()
    out[b_key] = out[b_key][sel].contiguous()
    return out
