"""Horizontal-flip utilities for mirror augmentation and flip test-time
augmentation.

Port of ``stlpose_tpu/ops/flip.py``. ``x[..., ::-1]`` has no negative-
stride form in torch: the width axis is reversed with ``torch.flip``. The
one-pixel shift builds a new tensor (column 0 keeps its own value, column
w takes column w - 1), never an in-place copy between overlapping views.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch import constants


def _pair_permutation(num_joints: int, flip_pairs) -> np.ndarray:
    perm = np.arange(num_joints)
    for a, b in flip_pairs:
        perm[a], perm[b] = b, a
    return perm


FLIP_PERM = _pair_permutation(constants.NUM_COCO_KPTS, constants.FLIP_PAIRS)


def _perm(n, flip_pairs, device):
    return torch.as_tensor(_pair_permutation(n, flip_pairs), device=device)


def _shift_right(x, dim: int):
    """Column w takes column w - 1 along ``dim``; column 0 keeps its own."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)


def flip_back(heatmaps, flip_pairs=constants.FLIP_PAIRS):
    """Un-flip (N, J, H, W) heatmaps of a mirrored input: reverse the width
    axis and swap each left/right channel pair."""
    perm = _perm(heatmaps.shape[1], flip_pairs, heatmaps.device)
    return torch.flip(heatmaps, dims=[3])[:, perm]


def flip_back_nhwc(heatmaps, flip_pairs=constants.FLIP_PAIRS):
    """:func:`flip_back` in the model's (N, H, W, J) layout."""
    perm = _perm(heatmaps.shape[3], flip_pairs, heatmaps.device)
    return torch.flip(heatmaps, dims=[2])[..., perm]


def average_flip_tta_nhwc(heatmaps, heatmaps_flipped, shift: bool = True):
    """(N, H, W, J) flip-TTA combine (see :func:`average_flip_tta`)."""
    unflipped = flip_back_nhwc(heatmaps_flipped)
    if shift:
        unflipped = _shift_right(unflipped, 2)
    return 0.5 * (heatmaps + unflipped)


def fliplr_joints(joints, joints_vis, width, flip_pairs=constants.FLIP_PAIRS):
    """Mirror joint annotations for a horizontally flipped image:
    x -> width - x - 1, left/right pairs swapped, invisible joints zeroed.

    joints (..., J, 2 or 3); joints_vis (..., J). Returns (joints, vis)."""
    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32)
    perm = _perm(joints.shape[-2], flip_pairs, joints.device)
    flipped = torch.cat([(width - joints[..., :1] - 1.0), joints[..., 1:]],
                        dim=-1)
    flipped = flipped.index_select(-2, perm)
    vis = vis.index_select(-1, perm)
    return flipped * vis[..., None], vis


def average_flip_tta(heatmaps, heatmaps_flipped, shift: bool = True):
    """Combine the direct and the mirrored forward passes, (N, J, H, W):
    un-flip the mirrored heatmaps, shift them one pixel right (HRNet's
    feature-map alignment) and average, ``0.5 * (direct + unflipped)``."""
    unflipped = flip_back(heatmaps_flipped)
    if shift:
        unflipped = _shift_right(unflipped, 3)
    return 0.5 * (heatmaps + unflipped)
