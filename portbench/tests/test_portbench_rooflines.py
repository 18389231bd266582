"""Each kernel's operation and byte count against a hand count at one
shape."""

from __future__ import annotations

import torch

from portbench import harness as H


def rl(name):
    return H.load_module("roofline", name)


def test_k1_decode():
    inp = rl("k1_decode").capture((torch.zeros(2, 3, 4, 5),), {}, None)
    # 120 map values read, (x, y, max, shift x, shift y) written per map
    assert rl("k1_decode").work(inp)[:2] == (0.0, 120 * 4 + 6 * 5 * 4)


def test_k2_crop_warp():
    images = torch.zeros(1, 8, 8, 3)
    # identity map: a 4 x 2 crop reads the 8 pixels it covers
    params = torch.tensor([[1.0, 0.0, 1.0, 2.0]])
    inp = rl("k2_crop_warp").capture(
        (images, params, torch.zeros(1, dtype=torch.int32), (4, 2)), {},
        None)
    out = 4 * 2 * 3 * 4
    assert rl("k2_crop_warp").work(inp)[1] == out + 8 * 3 * 4 + 20


def test_k2_counts_each_pixel_once():
    images = torch.zeros(1, 8, 8, 3)
    # two identical crops of one image read its pixels once
    params = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2)
    inp = rl("k2_crop_warp").capture(
        (images, params, torch.zeros(2, dtype=torch.int32), (2, 2)), {},
        None)
    assert rl("k2_crop_warp").work(inp)[1] == 2 * 16 * 3 + 4 * 12 + 40


def test_k4_affine_warp():
    canvases = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    # rows (u, r, txr, b, a, ty, swap, 0) of the unrotated identity map
    params = torch.tensor([[1.0, 0.0, 3.0, 0.0, 1.0, 5.0, 0.0, 0.0]])
    inp = rl("k4_affine_warp").capture((canvases, params, (4, 2)), {}, None)
    assert rl("k4_affine_warp").work(inp)[1] == 4 * 2 * 3 * 4 + 8 * 3 + 32


def test_k3_roi_align():
    level = torch.zeros(1, 20, 20, 2)
    # a 7 x 7 box at stride 1: 14 x 14 samples at 0.25 + 0.5 k, nearest
    # pixels 0..7 on each axis (8 x 8 distinct)
    boxes = torch.tensor([[[0.0, 0.0, 7.0, 7.0]]])
    out = torch.zeros(1, 1, 7, 7, 2)
    inp = rl("k3_roi_align").capture(
        ([level], boxes, torch.zeros(1, 1, dtype=torch.int32), [1.0]), {},
        out)
    assert rl("k3_roi_align").work(inp)[1] == 49 * 2 * 4 + 64 * 2 * 4 + 20


def test_k5_nms():
    inp = rl("k5_nms").capture((torch.zeros(2, 10, 4), torch.zeros(2, 10)),
                               {}, None)
    assert rl("k5_nms").work(inp)[1] == 2 * 10 * 22
