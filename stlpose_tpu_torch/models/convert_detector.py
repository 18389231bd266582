"""torchvision Faster R-CNN checkpoints -> the port's ``FasterRCNN``.

Counterpart of ``stlpose_tpu/models/convert_detector.py::
torch_fasterrcnn_to_flax``: a torchvision ``fasterrcnn_resnet50_fpn``
state dict (the reference fine-tunes torchvision's COCO-pretrained
detector and saves its checkpoints in that layout) in the port's names.
Both sides are torch modules, so convolution and dense layouts stay; only
names change, and ``fc6``'s input dimension, which torchvision flattens
from (C, 7, 7) and the port (as the reference) from (7, 7, C). Both the
old (``rpn.head.conv.weight``) and the new (``rpn.head.conv.0.0.weight``,
``fpn.inner_blocks.{i}.0.weight``) torchvision namings are accepted;
``num_batches_tracked`` is dropped. torchvision's FrozenBatchNorm2d
statistics map onto the trunk's BatchNorm unchanged.
``torch_efficientdet_to_flax`` waits for EfficientDet.
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
