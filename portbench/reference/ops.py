"""Plain PyTorch versions of the geometry, sampling, decoding and
suppression steps that the served, trained and extracted paths take.

Written from the published recipes (HRNet's crop geometry, Gaussian
targets and quarter-pixel refinement; torchvision's box coder, RoIAlign
with ``aligned=False`` and greedy NMS) one rounded op at a time, with no
kernel and nothing of the program imported. Every function takes and
returns torch tensors on any device.
"""

from __future__ import annotations

import math

import torch

PIXEL_STD = 200.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
              (15, 16))
JOINT_LOSS_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5,
                      1.0, 1.0, 1.2, 1.2, 1.5, 1.5)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def flip_perm(n: int) -> list:
    perm = list(range(n))
    for a, b in FLIP_PAIRS:
        perm[a], perm[b] = b, a
    return perm


# ------------------------------------------------------------ crop geometry
def _cos_sin(rot_deg, device):
    """cos and sin of an angle in degrees: the radians in f32, as the
    configuration computes, the functions in f64 rounded once to f32."""
    rad = torch.as_tensor(rot_deg, dtype=torch.float32,
                          device=device) * (math.pi / 180.0)
    return torch.cos(rad.double()).float(), torch.sin(rad.double()).float()


def inverse_params(center, scale, rot_deg, out_w: int, out_h: int):
    """(a, b, tx, ty) of the destination -> source similarity of an HRNet
    crop: source = [[a, -b], [b, a]] @ dst + (tx, ty); f32."""
    center = center.float()
    src_w = scale[..., 0].float() * PIXEL_STD
    cs, sn = _cos_sin(rot_deg, center.device)
    lam = src_w / out_w
    a, b = lam * cs, lam * sn
    tx = center[..., 0] - (a * out_w * 0.5 - b * out_h * 0.5)
    ty = center[..., 1] - (b * out_w * 0.5 + a * out_h * 0.5)
    return a, b, tx, ty


def forward_matrix(center, scale, rot_deg, out_w: int, out_h: int):
    """(..., 2, 3) source -> destination crop matrices."""
    center = center.float()
    src_w = scale[..., 0].float() * PIXEL_STD
    cs, sn = _cos_sin(rot_deg, center.device)
    lam = out_w / src_w
    a, b = lam * cs, -lam * sn
    tx = out_w * 0.5 - (a * center[..., 0] - b * center[..., 1])
    ty = out_h * 0.5 - (b * center[..., 0] + a * center[..., 1])
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)


def apply_matrix(points, mat):
    x, y = points[..., 0], points[..., 1]
    m = mat[..., None, :, :]
    return torch.stack([m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2],
                        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]],
                       -1)


def boxes_to_center_scale(boxes, aspect_ratio: float, padding: float = 1.25):
    """xyxy boxes -> (center, scale in 200-px units), grown to the aspect
    ratio and padded."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
    h = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w = torch.maximum(w, h * aspect_ratio)
    return (torch.stack([cx, cy], -1),
            torch.stack([w, h], -1) / PIXEL_STD * padding)


def heatmap_to_image(coords, center, scale, hm_w: int, hm_h: int):
    """(K, J, 2) heatmap coordinates -> source pixels (rotation 0)."""
    a, b, tx, ty = (v[:, None] for v in
                    inverse_params(center, scale, 0.0, hm_w, hm_h))
    x, y = coords[..., 0], coords[..., 1]
    return torch.stack([a * x - b * y + tx, b * x + a * y + ty], -1)


def bilinear_crops(images, img_idx, center, scale, out_w: int, out_h: int):
    """K crops (K, out_h, out_w, C) of (B, H, W, C) f32 images, crop k from
    image img_idx[k]: bilinear samples at the inverse similarity, taps
    outside the image reading 0."""
    B, H, W, C = images.shape
    dev = images.device
    a, b, tx, ty = (v[:, None, None] for v in
                    inverse_params(center, scale,
                                   torch.zeros(center.shape[0], device=dev),
                                   out_w, out_h))
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    sx = a * gx - b * gy + tx
    sy = b * gx + a * gy + ty
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(B * H * W, C)
    base = img_idx.long()[:, None, None] * (H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(ok[..., None], v, 0.0)

    return (tap(y0, x0) * ((1 - fx) * (1 - fy)) + tap(y0, x0 + 1) *
            (fx * (1 - fy)) + tap(y0 + 1, x0) * ((1 - fx) * fy) +
            tap(y0 + 1, x0 + 1) * (fx * fy))


def _lerp(src, pos, dim):
    """Linear resample of (N, A, B, C) ``src`` along ``dim`` at ``pos``,
    taps outside the axis reading 0."""
    size = src.shape[dim]
    p0 = torch.floor(pos)
    w = (pos - p0)[..., None]
    i0 = p0.clamp(-2, size + 1).long()

    def tap(i):
        ok = (i >= 0) & (i < size)
        idx = i.clamp(0, size - 1)[..., None].expand(*i.shape, src.shape[3])
        return torch.where(ok[..., None], torch.gather(src, dim, idx), 0.0)

    return tap(i0) * (1.0 - w) + tap(i0 + 1) * w


def two_pass_crops(canvases, center, scale, rot_deg, out_w: int,
                   out_h: int, may_rotate: bool = True):
    """The Catmull-Smith two-pass rotated crop of square (N, S, S, C)
    canvases (crop n from canvas n): where |a| < |b| the canvas is turned
    by 90 degrees first; pass 1 resamples every source row along x at
    x = u*x' - r*y + txr, pass 2 every column along y at y = b*x' + a*y'
    + ty (u = a + b*r, r = b/a, txr = tx + r*ty). f32 (N, out_h, out_w, C).
    """
    S = canvases.shape[1]
    dev = canvases.device
    imgs = canvases.float()
    a, b, tx, ty = inverse_params(center, scale, rot_deg, out_w, out_h)
    swap = torch.zeros_like(a, dtype=torch.bool)
    if may_rotate:
        swap = torch.abs(a) < torch.abs(b)
        a, b, tx, ty = (torch.where(swap, b, a), torch.where(swap, -a, b),
                        torch.where(swap, ty, tx),
                        torch.where(swap, (S - 1.0) - tx, ty))
    imgs = torch.where(swap[:, None, None, None],
                       torch.rot90(imgs, 1, (1, 2)), imgs)
    r = b / a
    u, txr = a + b * r, tx + r * ty
    u, r, txr, b, a, ty = (v[:, None, None] for v in (u, r, txr, b, a, ty))
    row = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
    col = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    h = _lerp(imgs, u * col - r * row + txr, dim=2)
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    return _lerp(h, b * col + a * yy + ty, dim=1)


def normalise(crops255):
    dev = crops255.device
    return ((crops255 / 255.0 - torch.tensor(IMAGENET_MEAN, device=dev)) /
            torch.tensor(IMAGENET_STD, device=dev))


# ------------------------------------------------------- targets, decoding
def gaussian_targets(joints, vis, hm_w=48, hm_h=64, img_w=192, img_h=256,
                     sigma=2.0):
    """HRNet's targets: a Gaussian of ``sigma`` around each joint's
    integer-quantised heatmap position inside a (6 sigma + 1)^2 window;
    a joint whose window misses the map gets weight 0. Returns targets
    (N, J, hm_h, hm_w) and weights (N, J) times the per-joint loss
    weights."""
    dev = joints.device
    mx = torch.trunc(joints[..., 0] / (img_w / hm_w) + 0.5)
    my = torch.trunc(joints[..., 1] / (img_h / hm_h) + 0.5)
    t = sigma * 3.0
    ul_x, ul_y, br_x, br_y = mx - t, my - t, mx + t + 1, my + t + 1
    inside = ~((ul_x >= hm_w) | (ul_y >= hm_h) | (br_x < 0) | (br_y < 0))
    weight = vis.float() * inside.float()
    gx = torch.arange(hm_w, dtype=torch.float32, device=dev)
    gy = torch.arange(hm_h, dtype=torch.float32, device=dev)
    dx2 = (gx - mx[..., None]) ** 2
    dy2 = (gy - my[..., None]) ** 2
    g = torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) /
                  (2.0 * sigma ** 2))
    win = (((gy >= ul_y[..., None]) & (gy < br_y[..., None]))[..., :, None]
           & ((gx >= ul_x[..., None]) & (gx < br_x[..., None]))[..., None, :])
    target = torch.where(win & (weight > 0.5)[..., None, None], g, 0.0)
    return target, weight * torch.tensor(JOINT_LOSS_WEIGHTS, device=dev)


def peaks(heatmaps):
    """(N, J, H, W) -> argmax (x, y) (lowest index on ties; zeroed where
    the max is <= 0), the maxima, and the quarter-pixel shift toward the
    larger neighbour (0 on the border)."""
    N, J, H, W = heatmaps.shape
    flat = heatmaps.reshape(N, J, H * W)
    maxvals = flat.amax(-1)
    pos = torch.arange(H * W, device=flat.device).expand_as(flat)
    idx = torch.where(flat == maxvals[..., None], pos, H * W).amin(-1)
    ok = (maxvals > 0).float()
    x, y = (idx % W).float() * ok, (idx // W).float() * ok
    shift = refine_shift(flat, x, y, H, W)
    return torch.stack([x, y], -1), maxvals, shift


def refine_shift(flat, x, y, H, W):
    """The quarter-pixel shift at integer positions (x, y) of (N, J, H*W)
    maps, and 0 where the position is not strictly inside the border."""
    px, py = torch.floor(x + 0.5).long(), torch.floor(y + 0.5).long()
    ok = ((px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)).float()
    pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * W + xx)[..., None])[..., 0]

    dx = at(pyc, pxc + 1) - at(pyc, pxc - 1)
    dy = at(pyc + 1, pxc) - at(pyc - 1, pxc)
    return torch.stack([torch.sign(dx), torch.sign(dy)], -1) * 0.25 * \
        ok[..., None]


def flip_tta(direct_nchw, mirrored_nchw):
    """HRNet's flip test: the mirrored maps flipped back, channels swapped,
    shifted one pixel right, averaged with the direct ones."""
    back = torch.flip(mirrored_nchw, dims=[3])[:, flip_perm(
        mirrored_nchw.shape[1])]
    back = torch.cat([back[..., :1], back[..., :-1]], dim=3)
    return 0.5 * (direct_nchw + back)


def pose_mse(pred, target, weight):
    """0.5 * mean over batch, joints and pixels of (w * (pred - target))^2."""
    n, j = weight.shape
    d = (pred.reshape(n, j, -1) - target.reshape(n, j, -1)) * weight[..., None]
    return 0.5 * torch.mean(d * d)


# ---------------------------------------------------------------- detection
def top_k(x, k: int):
    """The k largest along the last axis, descending, lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    pw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    ph = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    cx = deltas[..., 0] / wx * pw + px
    cy = deltas[..., 1] / wy * ph + py
    w = torch.exp(torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)) * pw
    h = torch.exp(torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def clip_boxes(boxes, size: float):
    return boxes.clamp(0.0, size)


def greedy_nms(boxes, scores, valid, thresh: float, max_keep: int):
    """Greedy IoU suppression per image over (B, M) candidates: up to
    ``max_keep`` picks in score order (lowest index on ties), each removing
    the alive boxes that overlap it by more than ``thresh``. Returns the
    (B, M) keep mask."""
    B, M = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    alive = valid & (scores > -torch.inf)
    keep = torch.zeros_like(alive)
    ar = torch.arange(M, device=scores.device)
    ninf = torch.tensor(-torch.inf, device=scores.device)
    for _ in range(min(max_keep, M)):
        i = torch.argmax(torch.where(alive, scores, ninf), 1, keepdim=True)
        ok = torch.gather(alive, 1, i)
        bx = torch.gather(boxes, 1, i[..., None].expand(B, 1, 4))[:, 0]
        inter = (torch.clamp(torch.minimum(x2, bx[:, 2:3]) -
                             torch.maximum(x1, bx[:, 0:1]), min=0) *
                 torch.clamp(torch.minimum(y2, bx[:, 3:4]) -
                             torch.maximum(y1, bx[:, 1:2]), min=0))
        iou = inter / torch.clamp(areas + torch.gather(areas, 1, i) - inter,
                                  min=1e-9)
        picked = ar[None] == i
        keep = keep | (picked & ok)
        alive = torch.where(ok, alive & ~(iou > thresh) & ~picked, alive)
    return keep


def roi_align(levels, boxes, strides, out: int = 7, sr: int = 2):
    """FPN RoIAlign (torchvision's ``aligned=False`` rules, out x out bins
    of sr x sr samples) of (B, P, 4) boxes, each on its canonical level
    floor(4 + log2(sqrt(area) / 224)) of the (B, h, w, C) maps P2...
    Returns (B, P, out, out, C) f32."""
    B, P = boxes.shape[:2]
    C = levels[0].shape[-1]
    dev = boxes.device
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) *
            torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    lv = (torch.clamp(torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 +
                                                   1e-8)),
                      2, 1 + len(levels)) - 2).long().reshape(-1)
    flat = boxes.reshape(B * P, 4)
    img = torch.arange(B, device=dev).repeat_interleave(P)
    res = torch.zeros((B * P, out, out, C), device=dev)
    s = torch.arange(out * sr, device=dev)
    pos = (s // sr).float() + ((s % sr).float() + 0.5) / sr
    n_t = torch.tensor(float(out), device=dev)
    for li, (feat, stride) in enumerate(zip(levels, strides)):
        sel = torch.nonzero(lv == li)[:, 0]
        if not sel.numel():
            continue
        _, H, W, _ = feat.shape
        bb = flat[sel] * (1.0 / stride)

        def axis(lo, hi, size):
            g = lo[:, None] + pos[None] * (torch.clamp(hi - lo, min=1.0) /
                                           n_t)[:, None]
            inside = (g >= -1.0) & (g <= size)
            gc = torch.clamp(g, 0.0, size - 1)
            g0 = torch.floor(gc)
            i0 = g0.long()
            return i0, (i0 + 1).clamp(max=size - 1), gc - g0, inside

        x0, x1, fx, inx = axis(bb[:, 0], bb[:, 2], W)
        y0, y1, fy, iny = axis(bb[:, 1], bb[:, 3], H)
        fm = feat.reshape(-1, C).float()
        base = img[sel][:, None, None] * (H * W)

        def tap(yi, xi):
            return fm[base + yi[:, :, None] * W + xi[:, None, :]]

        fx, fy = fx[:, None, :, None], fy[:, :, None, None]
        v = (tap(y0, x0) * ((1 - fx) * (1 - fy)) + tap(y0, x1) *
             (fx * (1 - fy)) + tap(y1, x0) * ((1 - fx) * fy) +
             tap(y1, x1) * (fx * fy))
        v = torch.where((iny[:, :, None] & inx[:, None, :])[..., None], v,
                        0.0).reshape(-1, out, sr, out, sr, C)
        res[sel] = (v[:, :, 0, :, 0] + v[:, :, 0, :, 1] + v[:, :, 1, :, 0]
                    + v[:, :, 1, :, 1]) * 0.25
    return res.reshape(B, P, out, out, C)
