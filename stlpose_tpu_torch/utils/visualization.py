"""Drawing on the host: skeleton overlays, boxes, heatmap grids.

Port of ``stlpose_tpu/utils/visualization.py``, the toolbox of the
qualitative vase evaluation (``engines/vase_evaluator.py``) and of the
evaluator's crop dumps (``engines/evaluator.py``). matplotlib is imported
inside each function, on its Agg backend: the card's machine has no
matplotlib, and nothing here runs on the card.
"""

from __future__ import annotations

import numpy as np

from stlpose_tpu_torch import constants

# per-limb colors (cycled)
_LIMB_COLORS = [
    "#e6194b", "#3cb44b", "#ffe119", "#4363d8", "#f58231", "#911eb4",
    "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080", "#e6beff",
    "#9a6324", "#fffac8", "#800000", "#aaffc3", "#808000", "#ffd8b1",
]


def _ax(ax=None, figsize=(8, 8)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=figsize)
        return fig, ax
    return ax.figure, ax


def visualize_image(img, ax=None, title=None, savepath=None):
    """Plain image display."""
    fig, ax = _ax(ax)
    img = np.asarray(img)
    if img.max() > 1.5:
        img = img / 255.0
    ax.imshow(np.clip(img, 0, 1))
    ax.axis("off")
    if title:
        ax.set_title(title)
    if savepath:
        fig.savefig(savepath, bbox_inches="tight")
        _close(fig)
    return ax


def draw_pose(img, poses, skeleton=constants.SKELETON_HRNET,
              keypoint_scores=None, kpt_thr: float = 0.1, ax=None,
              title=None, savepath=None):
    """Skeleton overlay with per-limb colors.

    Args:
      img: (H, W, 3) image or None for a blank canvas.
      poses: (P, J, >=2) keypoint arrays; joints at (0, 0) or with score
        below ``kpt_thr`` are not drawn.
    """
    fig, ax = _ax(ax)
    if img is not None:
        img = np.asarray(img)
        if img.max() > 1.5:
            img = img / 255.0
        ax.imshow(np.clip(img, 0, 1))
    poses = np.asarray(poses)
    if poses.ndim == 2:
        poses = poses[None]
    for pose in poses:
        for li, (a, b) in enumerate(skeleton):
            a, b = abs(a), abs(b)
            if a >= len(pose) or b >= len(pose):
                continue
            pa, pb = pose[a], pose[b]
            if _hidden(pa, kpt_thr) or _hidden(pb, kpt_thr):
                continue
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]],
                    color=_LIMB_COLORS[li % len(_LIMB_COLORS)], linewidth=3)
        for kp in pose:
            if not _hidden(kp, kpt_thr):
                ax.plot(kp[0], kp[1], "o", markersize=4, color="white",
                        markeredgecolor="black")
    ax.axis("off")
    if title:
        ax.set_title(title)
    if savepath:
        fig.savefig(savepath, bbox_inches="tight")
        _close(fig)
    return ax


def _hidden(kp, thr):
    if kp[0] == 0 and kp[1] == 0:
        return True
    return len(kp) > 2 and kp[2] < thr


def visualize_bbox(img, boxes, scores=None, labels=None, ax=None,
                   title=None, savepath=None, color="lime"):
    """Bounding-box overlay.

    boxes: (K, 4) xyxy.
    """
    import matplotlib.patches as patches

    fig, ax = _ax(ax)
    img = np.asarray(img)
    if img.max() > 1.5:
        img = img / 255.0
    ax.imshow(np.clip(img, 0, 1))
    for i, box in enumerate(np.asarray(boxes)):
        x1, y1, x2, y2 = box[:4]
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       linewidth=2, edgecolor=color,
                                       facecolor="none"))
        if scores is not None:
            ax.text(x1, max(0, y1 - 4), f"{float(scores[i]):.2f}",
                    color=color, fontsize=9,
                    bbox=dict(facecolor="black", alpha=0.5, pad=1))
    ax.axis("off")
    if title:
        ax.set_title(title)
    if savepath:
        fig.savefig(savepath, bbox_inches="tight")
        _close(fig)
    return ax


def visualize_heatmaps(heatmaps, n_cols: int = 6, savepath=None):
    """Per-joint heatmap debug grid, one panel per joint."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    heatmaps = np.asarray(heatmaps)
    n = heatmaps.shape[0]
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(2 * n_cols, 2 * n_rows))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        if i < n:
            ax.imshow(heatmaps[i])
            ax.set_title(constants.COCO_KPT_NAMES[i] if i < 17 else str(i),
                         fontsize=7)
        ax.axis("off")
    if savepath:
        fig.savefig(savepath, bbox_inches="tight")
        _close(fig)
    return fig


def visualize_subset_heatmaps(images, heatmaps, n: int = 3, savepath=None):
    """Image / keypoint-map / overlay debug grid for the legacy OpenPose
    full-image heatmaps: the inverted background channel is drawn.

    Args:
      images: (N, H, W, 3) float or uint8 images (NHWC).
      heatmaps: (N, K+1, H, W), the last channel the background.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    heatmaps = np.asarray(heatmaps)
    n = min(n, images.shape[0])
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        img = _to_uint8(images[i])
        kpt_map = 1.0 - heatmaps[i, -1]          # invert the background ch
        axes[i][0].imshow(img)
        axes[i][0].set_title("Original Image", fontsize=8)
        axes[i][1].imshow(kpt_map * 255.0)
        axes[i][1].set_title("Keypoint Maps", fontsize=8)
        overlay = img.astype(np.float32) * 0.5 + (kpt_map * 255.0)[..., None]
        axes[i][2].imshow(np.clip(overlay, 0, 255).astype(np.uint8))
        axes[i][2].set_title("Overlay", fontsize=8)
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if savepath:
        fig.savefig(savepath, bbox_inches="tight", pad_inches=0)
        _close(fig)
    return fig


def visualize_subset_pafs(images, pafs, channels=(0, 4, 8), n: int = 3,
                          savepath=None):
    """Image / PAF-magnitude / red-overlay debug grid for the legacy Part
    Affinity Fields: |paf| summed over ``channels``, hit pixels red.

    Args:
      images: (N, H, W, 3) images (NHWC).
      pafs: (N, 2L, H, W) part affinity fields.
      channels: the channels summed for the display.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    pafs = np.asarray(pafs)
    n = min(n, images.shape[0])
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        img = _to_uint8(images[i])
        mag = np.sum([np.abs(pafs[i, c]) for c in channels], axis=0)
        axes[i][0].imshow(img)
        axes[i][0].set_title("Original Image", fontsize=8)
        axes[i][1].imshow(np.clip(mag * 1000.0, 0, 255).astype(np.uint8))
        axes[i][1].set_title("PAFs", fontsize=8)
        overlay = img.copy()
        overlay[mag > 0] = (255, 0, 0)
        axes[i][2].imshow(overlay)
        axes[i][2].set_title("Overlay", fontsize=8)
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if savepath:
        fig.savefig(savepath, bbox_inches="tight")
        _close(fig)
    return fig


def _to_uint8(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.copy()
    if img.max() <= 1.5:                         # normalized-ish floats
        img = img * 255.0
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _close(fig):
    import matplotlib.pyplot as plt
    plt.close(fig)
