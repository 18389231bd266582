"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference recomputed from the same seeded inputs and
weights.

Every discrete choice the program makes (which detections it keeps and
which of them fill the crop budget, each joint's peak and the direction
of its quarter-pixel shift) is judged by the gap in the reference's own
score by which the program's choice falls short of the reference's best
choice, as a fraction of that score's scale: a near-tie that rounding
resolves the other way reads as the size of the tie, a wrong choice as a
large gap. Every continuous output (box corners, scores, heatmap maxima,
keypoint coordinates) is judged by its distance from the reference's
value for the same choice. Each function returns the numbers of one
sample; the caller takes the worst over the samples.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models, ops

CROP_W, CROP_H = 192, 256


def _hm_choice(hm, x_i, y_i, v, zeroed, kpt_thr):
    """Gaps of one crop's joints. ``hm`` (J, H, W) reference heatmaps;
    ``x_i``, ``y_i`` (J,) the program's integer peak positions, ``v``
    (J,) its maxima, ``zeroed`` (J,) where it reported nothing (maximum
    under ``kpt_thr``). Returns (peak_gap, maxval_gap, scale)."""
    J, H, W = hm.shape
    flat = hm.reshape(J, H * W)
    scale = float(flat.abs().max().clamp_min(1e-30))
    ref_max = flat.amax(-1)
    xi = x_i.clamp(0, W - 1).long()
    yi = y_i.clamp(0, H - 1).long()
    at = torch.gather(flat, 1, (yi * W + xi)[:, None])[:, 0]
    # K1's convention: a map whose maximum is <= 0 reports (0, 0)
    nonpos = (x_i == 0) & (y_i == 0) & (v <= 0)
    choice = torch.where(nonpos, torch.clamp(ref_max, min=0.0),
                         ref_max - at)
    val = torch.where(nonpos, (v - ref_max).abs(), (v - at).abs())
    thr = torch.tensor(float(kpt_thr), device=hm.device)
    gap = torch.where(zeroed, torch.clamp(ref_max - thr, min=0.0), choice)
    val = torch.where(zeroed, torch.zeros_like(val), val)
    return (float(gap.max()) / scale, float(val.max()) / scale, scale)


def _shift_gap(hm, x_i, y_i, shift_q):
    """How far the reference's neighbour difference lies on the other side
    of each program quarter-pixel shift ``shift_q`` (J, 2) in {-1, 0, 1};
    0 where they agree."""
    J, H, W = hm.shape
    flat = hm.reshape(1, J, H * W)
    ref = ops.refine_shift(flat, x_i[None].float(), y_i[None].float(),
                           H, W)[0] * 4.0                       # (J, 2)
    px, py = x_i.long(), y_i.long()
    inside = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
    pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)
    f = flat[0]

    def at(yy, xx):
        return torch.gather(f, 1, (yy * W + xx)[:, None])[:, 0]

    d = torch.stack([at(pyc, pxc + 1) - at(pyc, pxc - 1),
                     at(pyc + 1, pxc) - at(pyc - 1, pxc)], -1)
    wrong = shift_q != ref
    # inside the border the shift follows sign(d): a disagreement costs
    # |d|; on the border the shift is 0, and any other costs the whole
    # scale of the maps
    scale = f.abs().max()
    cost = torch.where(inside[:, None], d.abs(), scale.expand_as(d))
    return float(torch.where(wrong, cost, torch.zeros_like(cost)).max())


# ----------------------------------------------------------------- serving
def serve(Wd, dcfg, Wp, pcfg, images_u8, results, params):
    """One fused call of ``process_images``: ``images_u8`` (B, S, S, 3)
    the batch handed in (on the device), ``results`` the B per-image dicts
    it returned. Returns the sample's numbers."""
    dev = images_u8.device
    m, budget = params["max_dets"], params["budget"]
    thr, kpt_thr = params["bbox_thr"], params["kpt_thr"]
    images01 = images_u8.float() / 255.0
    cand, sc, kept = models.detect(Wd, dcfg, images01)
    eligible = kept & (sc >= thr)
    box_px = score = rank = 0.0
    picked, unpicked, crops = [], [], []
    n_total = 0
    for i, r in enumerate(results):
        pb = torch.as_tensor(np.asarray(r["boxes"], np.float32), device=dev)
        ps = torch.as_tensor(np.asarray(r["scores"], np.float32),
                             device=dev)
        n = pb.shape[0]
        n_total += n
        # each program detection against its nearest reference candidate;
        # the match is one to one: a detection that repeats a matched
        # candidate costs the whole score scale (scores lie in [0, 1])
        if n:
            cost = ((pb[:, None] - cand[i][None]).abs().amax(-1) +
                    1e3 * (ps[:, None] - sc[i][None]).abs())
            j = cost.argmin(1)
            box_px = max(box_px, float((pb - cand[i][j]).abs().max()))
            score = max(score, float((ps - sc[i][j]).abs().max()))
            if len(set(j.tolist())) < n:
                rank = max(rank, 1.0)
        else:
            j = torch.zeros(0, dtype=torch.long, device=dev)
        s_ref = sc[i][j]
        # a kept choice the reference would not keep: by how much the
        # reference's score misses the cut, or loses to a suppressor
        for jj in j.tolist():
            if not bool(eligible[i, jj]):
                rank = max(rank, _membership_gap(cand[i], sc[i], kept[i],
                                                 jj, thr, dcfg))
        # a reference choice the program left out
        left = eligible[i].clone()
        left[j] = False
        if bool(left.any()):
            # with its m slots filled, none left out may beat the weakest
            # kept; with a slot free, none may be left out at all
            cut = float(s_ref.min()) if n == m else 0.0
            rank = max(rank, float(sc[i][left].max()) - cut)
        k = len(r["crop_keypoints"])
        for q in range(n):
            (picked if q < k else unpicked).append(float(s_ref[q]))
        if k:
            crops.append((i, cand[i][j[:k]], r["crop_keypoints"],
                          r["image_keypoints"]))
    # the crop budget: filled by the best-scored detections of the batch
    if unpicked:
        cut = min(picked) if len(picked) == min(budget, n_total) else 0.0
        rank = max(rank, max(unpicked) - cut)
    peak = maxval = kp_px = 0.0
    for i, boxes, crop_kp, img_kp in crops:
        center, scale = ops.boxes_to_center_scale(boxes, CROP_W / CROP_H)
        idx = torch.full((boxes.shape[0],), i, device=dev)
        crop = ops.bilinear_crops(images01 * 255.0, idx, center, scale,
                                  CROP_W, CROP_H)
        hm = models.hrnet(Wp, pcfg, ops.normalise(crop))
        H, W = hm.shape[2:]
        ck = torch.as_tensor(np.asarray(crop_kp, np.float32), device=dev)
        ik = torch.as_tensor(np.asarray(img_kp, np.float32), device=dev)
        for c in range(hm.shape[0]):
            zeroed = (ck[c, :, 2] == 0) & (ck[c, :, 0] == 0) & \
                (ck[c, :, 1] == 0)
            x_i = torch.round(ck[c, :, 0] * ((W - 1) / (CROP_W - 1.0)))
            y_i = torch.round(ck[c, :, 1] * ((H - 1) / (CROP_H - 1.0)))
            g, v, s = _hm_choice(hm[c], x_i, y_i, ck[c, :, 2], zeroed,
                                 kpt_thr)
            peak, maxval = max(peak, g), max(maxval, v)
            live = ~zeroed
            if not bool(live.any()):
                continue
            # the image-frame keypoint: the program's peak and shift
            # mapped through the reference's crop of its box
            a, _, tx, ty = ops.inverse_params(center[c:c + 1],
                                              scale[c:c + 1], 0.0, W, H)
            hx = (ik[c, :, 0] - tx) / a
            hy = (ik[c, :, 1] - ty) / a
            q = torch.stack([torch.round((hx - x_i) * 4.0),
                             torch.round((hy - y_i) * 4.0)], -1)
            q = q.clamp(-1, 1)
            sg = _shift_gap(hm[c][live], x_i[live], y_i[live], q[live])
            peak = max(peak, sg / s)
            exp = ops.heatmap_to_image(
                (torch.stack([x_i, y_i], -1) + q * 0.25)[None],
                center[c:c + 1], scale[c:c + 1], W, H)[0]
            kp_px = max(kp_px, float((exp - ik[c, :, :2])[live].abs().max()))
            maxval = max(maxval, float(
                (ik[c, :, 2] - ck[c, :, 2])[live].abs().max()) / s)
    return {"box_px": box_px, "score": score, "rank_gap": rank,
            "peak_gap": peak, "maxval": maxval, "kp_px": kp_px}


def _membership_gap(cand, sc, kept, jj, thr, dcfg):
    """Why the reference does not keep candidate ``jj``, as a score gap:
    under a threshold by so much, or suppressed by a kept candidate that
    overlaps it and scores higher by so much."""
    s = float(sc[jj])
    gaps = [max(0.0, thr - s), max(0.0, dcfg["score_thresh"] - s)]
    if s >= thr and s > dcfg["score_thresh"]:
        b = cand[jj]
        lt = torch.maximum(cand[:, :2], b[:2])
        rb = torch.minimum(cand[:, 2:], b[2:])
        inter = torch.clamp(rb - lt, min=0).prod(-1)
        area = torch.clamp(cand[:, 2:] - cand[:, :2], min=0).prod(-1)
        iou = inter / torch.clamp(area + area[jj] - inter, min=1e-9)
        sup = kept & (iou > dcfg["nms_thresh"])
        sup[jj] = False
        if bool(sup.any()):
            gaps.append(max(0.0, float(sc[sup].max()) - s))
        else:
            # not suppressed and above both thresholds: dropped only by
            # the detections_per_img cut
            gaps.append(max(0.0, float(sc[kept].min()) - s))
    return max(gaps)


def serve_results(Wd, dcfg, Wp, pcfg, images_u8, params):
    """The reference in the program's place: ``process_images``'s results
    (boxes, scores, crop- and image-frame keypoints with the kpt_thr
    zeroing) computed by the plain reference."""
    dev = images_u8.device
    B = images_u8.shape[0]
    m, budget, thr = params["max_dets"], params["budget"], params["bbox_thr"]
    images01 = images_u8.float() / 255.0
    cand, sc, kept = models.detect(Wd, dcfg, images01)
    masked = torch.where(kept & (sc >= thr), sc, -torch.inf)
    top_s, top_i = ops.top_k(masked, m)
    sel_valid = top_s > -torch.inf
    sel_boxes = torch.gather(cand, 1, top_i[..., None].expand(-1, -1, 4))
    key = sel_valid.reshape(-1).float() * 10.0 + torch.where(
        sel_valid, top_s, 0.0).reshape(-1)
    _, idx = ops.top_k(key, min(budget, B * m))
    img_idx = idx // m
    pv = sel_valid.reshape(-1)[idx]
    boxes = sel_boxes.reshape(-1, 4)[idx]
    center, scale = ops.boxes_to_center_scale(boxes, CROP_W / CROP_H)
    crop = ops.bilinear_crops(images01 * 255.0, img_idx, center, scale,
                              CROP_W, CROP_H)
    hm = models.hrnet(Wp, pcfg, ops.normalise(crop))
    H, W = hm.shape[2:]
    coords, maxv, shift = ops.peaks(hm)
    crop_xy = coords * torch.tensor([(CROP_W - 1.0) / (W - 1),
                                     (CROP_H - 1.0) / (H - 1)], device=dev)
    ck = torch.cat([crop_xy, maxv[..., None]], -1)
    ik = torch.cat([ops.heatmap_to_image(coords + shift, center, scale, W,
                                         H), maxv[..., None]], -1)
    ck, ik = ck.cpu().numpy(), ik.cpu().numpy()
    for arr in (ck, ik):
        arr[arr[..., 2] < params["kpt_thr"]] = 0
    img_idx, pv = img_idx.cpu().numpy(), pv.cpu().numpy()
    out = []
    for i in range(B):
        v = sel_valid[i].cpu().numpy()
        pick = (img_idx == i) & pv
        out.append({"boxes": sel_boxes[i].cpu().numpy()[v],
                    "scores": top_s[i].cpu().numpy()[v],
                    "crop_keypoints": ck[pick], "image_keypoints": ik[pick]})
    return out


# -------------------------------------------------------------- extraction
def extract(Wp, pcfg, canvases_u8, centers, scales, peaks, entries,
            kpt_thr):
    """One extraction batch: ``canvases_u8`` (N, S, S, 3) the letterboxed
    images on the device, ``centers``/``scales`` (N, 2) their records,
    ``peaks`` (N, J, 3) the fetched [x, y, maxval] of ``batch_peaks`` and
    ``entries`` (N, J, 3) the database joints ``add_batch`` made."""
    dev = canvases_u8.device
    N = canvases_u8.shape[0]
    crops = ops.two_pass_crops(canvases_u8, centers, scales,
                               torch.zeros(N, device=dev), CROP_W, CROP_H,
                               may_rotate=False)
    hm = models.hrnet_flip(Wp, pcfg, ops.normalise(crops))
    H, W = hm.shape[2:]
    pk = torch.as_tensor(np.asarray(peaks, np.float32), device=dev)
    en = torch.as_tensor(np.asarray(entries, np.float32), device=dev)
    peak = maxval = 0.0
    for c in range(N):
        x_i, y_i, v = pk[c, :, 0], pk[c, :, 1], pk[c, :, 2]
        g, mv, s = _hm_choice(hm[c], x_i, y_i, v,
                              torch.zeros_like(v, dtype=torch.bool), kpt_thr)
        peak, maxval = max(peak, g), max(maxval, mv)
        # the database entry: its joint, taken back to the heatmap grid,
        # is judged as a peak choice, and its visibility flag by how far
        # the reference's value there lies from the threshold
        ex = torch.round(en[c, :, 0] * ((W - 1) / (CROP_W - 1.0)))
        ey = torch.round(en[c, :, 1] * ((H - 1) / (CROP_H - 1.0)))
        ge, _, _ = _hm_choice(hm[c], ex, ey, v,
                              torch.zeros_like(v, dtype=torch.bool), kpt_thr)
        peak = max(peak, ge)
        flat = hm[c].reshape(hm.shape[1], -1)
        at = torch.gather(flat, 1, (ey.long().clamp(0, H - 1) * W +
                                    ex.long().clamp(0, W - 1))[:, None])[:, 0]
        wrong = (at >= kpt_thr).float() != en[c, :, 2]
        if bool(wrong.any()):
            peak = max(peak, float((at - kpt_thr).abs()[wrong].max()) / s)
    return {"peak_gap": peak, "maxval": maxval}


def extract_results(Wp, pcfg, canvases_u8, centers, scales, kpt_thr):
    """The reference in the program's place: (peaks, entries)."""
    dev = canvases_u8.device
    N = canvases_u8.shape[0]
    crops = ops.two_pass_crops(canvases_u8, centers, scales,
                               torch.zeros(N, device=dev), CROP_W, CROP_H,
                               may_rotate=False)
    hm = models.hrnet_flip(Wp, pcfg, ops.normalise(crops))
    H, W = hm.shape[2:]
    coords, maxv, _ = ops.peaks(hm)
    peaks = torch.cat([coords, maxv[..., None]], -1).cpu().numpy()
    entries = peaks.copy()
    entries[..., 0] *= (CROP_W - 1.0) / (W - 1)
    entries[..., 1] *= (CROP_H - 1.0) / (H - 1)
    entries[..., 2] = (peaks[..., 2] >= kpt_thr).astype(np.float32)
    return peaks, entries
