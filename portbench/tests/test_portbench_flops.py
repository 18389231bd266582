"""The model FLOP counter against published counts (multiply-adds)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import flops, port
from portbench.harness import PKG

CFG = json.load(open(os.path.join(
    PKG, "configs", "frcnn_r50fpn_hrnet_w32.f32.json")))


@pytest.fixture(scope="module")
def shapes():
    """The program's parameter layout at full width, shapes only."""
    from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
    from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
    with torch.device("meta"):
        det = FasterRCNN(port.frcnn_config(CFG["detector"]), device="meta")
        pose = PoseHighResolutionNet(port.hrnet_config(CFG["pose"]),
                                     device="meta")
    return det.state_dict(), pose.state_dict()


def test_resnet50_at_224(shapes):
    # He et al. (2016): 3.8 G FLOPs "multiply-adds"; 4.1 G with the
    # torchvision layout (stride on the 3x3), the trunk's convolutions
    macs = flops.resnet_flops(shapes[0], CFG["detector"], 224) / 2
    assert macs == pytest.approx(4.1e9, rel=0.03)


def test_hrnet_w32_at_256x192(shapes):
    # Sun et al. (2019), Table 1: 7.1 G; this counter reads 7.65 G: every
    # convolution the network runs, the fuse and transition layers too,
    # which the published figure appears to undercount
    macs = flops.hrnet_flops(shapes[1], CFG["pose"]) / 2
    assert macs == pytest.approx(7.1e9, rel=0.10)


def test_detector_per_image(shapes):
    # trunk, FPN and RPN head at 400 x 400, box head on 256 proposals:
    # about 34 G multiply-adds an image
    macs = flops.detector_flops(shapes[0], CFG["detector"]) / 2
    assert macs == pytest.approx(34e9, rel=0.05)
