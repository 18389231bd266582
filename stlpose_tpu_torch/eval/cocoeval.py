"""COCO-style AP evaluation for bounding boxes and OKS keypoints.

Port of ``stlpose_tpu/eval/cocoeval.py``, the package's own vectorized
numpy COCOeval (no pycocotools), copied as it is. The published protocol:

  * 10 IoU/OKS thresholds 0.50:0.05:0.95, 101 recall points,
  * per-image greedy matching, ignore-last GT ordering, crowd GTs matchable
    many times (bbox IoU uses det-area union against crowds),
  * unmatched detections outside the area range are ignored, not FPs,
  * keypoints: OKS with the COCO sigmas, GTs with num_keypoints==0 ignored,
    area ranges all/medium/large, maxDets=20,
  * bbox: area ranges all/small/medium/large, maxDets=1/10/100.

The pairwise OKS/IoU matrices are vectorized; only the greedy match is a
(short) loop per image.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from stlpose_tpu_torch import constants


class Params:
    def __init__(self, iouType: str = "bbox"):
        self.iouType = iouType
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        self.useCats = 1
        if iouType == "keypoints":
            self.maxDets = [20]
            self.areaRng = [[0, 1e10], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.areaRngLbl = ["all", "medium", "large"]
            self.kpt_oks_sigmas = np.asarray(constants.OKS_SIGMAS)
        else:
            self.maxDets = [1, 10, 100]
            self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                            [96 ** 2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]


def _bbox_iou_matrix(dt_boxes, gt_boxes, gt_crowd):
    """Pairwise IoU, xywh boxes; crowd GT uses det-area-only union."""
    if len(dt_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(dt_boxes), len(gt_boxes)))
    d = np.asarray(dt_boxes, np.float64)
    g = np.asarray(gt_boxes, np.float64)
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    d_area = (d[:, 2] * d[:, 3])[:, None]
    g_area = (g[:, 2] * g[:, 3])[None, :]
    crowd = np.asarray(gt_crowd, bool)[None, :]
    union = np.where(crowd, d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _oks_matrix(dt_kpts, gt_kpts, gt_areas, gt_boxes, sigmas):
    """Pairwise OKS between detection and GT keypoint arrays.

    GT with no labeled keypoints falls back to the bbox-proximity surrogate
    of the standard protocol.
    """
    D, G = len(dt_kpts), len(gt_kpts)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    var = (np.asarray(sigmas) * 2.0) ** 2          # (K,)
    dt = np.asarray(dt_kpts, np.float64).reshape(D, -1, 3)
    gt = np.asarray(gt_kpts, np.float64).reshape(G, -1, 3)
    xd, yd = dt[:, :, 0], dt[:, :, 1]
    xg, yg, vg = gt[:, :, 0], gt[:, :, 1], gt[:, :, 2]
    areas = np.asarray(gt_areas, np.float64)
    boxes = np.asarray(gt_boxes, np.float64)

    ious = np.zeros((D, G))
    for j in range(G):
        k1 = int((vg[j] > 0).sum())
        if k1 > 0:
            dx = xd - xg[j][None, :]
            dy = yd - yg[j][None, :]
        else:
            # no labeled keypoints: measure distance to an expanded box
            x0, y0 = boxes[j, 0] - boxes[j, 2], boxes[j, 1] - boxes[j, 3]
            x1 = boxes[j, 0] + 2 * boxes[j, 2]
            y1 = boxes[j, 1] + 2 * boxes[j, 3]
            dx = np.clip(x0 - xd, 0, None) + np.clip(xd - x1, 0, None)
            dy = np.clip(y0 - yd, 0, None) + np.clip(yd - y1, 0, None)
        e = (dx ** 2 + dy ** 2) / var[None, :] / (areas[j] + np.spacing(1)) / 2.0
        if k1 > 0:
            mask = vg[j] > 0
            ious[:, j] = np.exp(-e[:, mask]).sum(axis=1) / k1
        else:
            ious[:, j] = np.exp(-e).mean(axis=1)
    return ious


class COCOeval:
    """Evaluate detections/keypoints against a COCO ground truth.

    Usage (same contract as the reference's calls):
        ev = COCOeval(coco_gt, coco_dt, iouType="keypoints")
        ev.params.imgIds = [...]
        ev.evaluate(); ev.accumulate(); ev.summarize()
        ev.stats  # numpy vector
    """

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs = {}
        self.eval = {}
        self.stats = np.array([])

    # ------------------------------------------------------------ evaluate
    def _prepare(self):
        p = self.params
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        gt_ids = self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        dt_ids = self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        for gt in self.cocoGt.loadAnns(gt_ids):
            ignore = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if p.iouType == "keypoints":
                ignore = ignore or gt.get("num_keypoints", 0) == 0
            gt["_ignore"] = int(bool(ignore))
            self._gts[(gt["image_id"], gt["category_id"])].append(gt)
        for dt in self.cocoDt.loadAnns(dt_ids):
            self._dts[(dt["image_id"], dt["category_id"])].append(dt)

    def evaluate(self):
        p = self.params
        p.imgIds = sorted(set(p.imgIds))
        p.catIds = sorted(set(p.catIds)) if p.useCats else [-1]
        self._prepare()
        max_det = p.maxDets[-1]
        # evalImgs keyed (img, cat, area_idx): matching is redone per area
        # range because GT ignore flags (and thus match order) depend on it.
        self.evalImgs = {}
        for cat in p.catIds:
            for img in p.imgIds:
                gts = self._gts[(img, cat)]
                dts = sorted(self._dts[(img, cat)],
                             key=lambda d: -d["score"])[:max_det]
                if not gts and not dts:
                    continue
                ious = self._iou_matrix(dts, gts)
                for a, aRng in enumerate(p.areaRng):
                    self.evalImgs[(img, cat, a)] = self._match(
                        dts, gts, ious, aRng)

    def _iou_matrix(self, dts, gts):
        p = self.params
        if p.iouType == "keypoints":
            return _oks_matrix([d["keypoints"] for d in dts],
                               [g["keypoints"] for g in gts],
                               [g["area"] for g in gts],
                               [g["bbox"] for g in gts],
                               p.kpt_oks_sigmas)
        return _bbox_iou_matrix([d["bbox"] for d in dts],
                                [g["bbox"] for g in gts],
                                [g.get("iscrowd", 0) for g in gts])

    def _match(self, dts, gts, ious, aRng):
        """Greedy per-threshold matching under one area range."""
        p = self.params
        T = len(p.iouThrs)
        D, G = len(dts), len(gts)
        gt_ig_base = np.array(
            [g["_ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]
             for g in gts], bool)
        # GT order: non-ignored first (stable), as in the standard protocol
        order_g = np.argsort(gt_ig_base, kind="mergesort")
        gt_ig = gt_ig_base[order_g]
        ious_o = ious[:, order_g] if G else ious

        gtm = np.zeros((T, G), np.int64)
        dtm = np.zeros((T, D), np.int64)
        dt_ig = np.zeros((T, D), bool)
        iscrowd = np.array([gts[int(j)].get("iscrowd", 0)
                            for j in order_g], bool) if G else np.zeros(0, bool)
        for t, thr in enumerate(p.iouThrs):
            for d in range(D):
                best = thr - 1e-10
                m = -1
                for g in range(G):
                    if gtm[t, g] > 0 and not iscrowd[g]:
                        continue
                    # GTs are ignore-sorted: once we have a non-ignored
                    # match, ignored GTs cannot improve it
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break
                    if ious_o[d, g] < best:
                        continue
                    best = ious_o[d, g]
                    m = g
                if m == -1:
                    continue
                dt_ig[t, d] = gt_ig[m]
                dtm[t, d] = gts[int(order_g[m])]["id"]
                gtm[t, m] = dts[d]["id"]
        # unmatched detections outside the area range are ignored, not FPs
        d_areas = np.array([d["area"] for d in dts], np.float64)
        d_out = (d_areas < aRng[0]) | (d_areas > aRng[1])
        dt_ig |= (dtm == 0) & d_out[None, :]
        return {
            "dt_scores": np.array([d["score"] for d in dts], np.float64),
            "dtm": dtm, "dt_ig": dt_ig,
            "n_gt": int((~gt_ig).sum()),
        }

    # ---------------------------------------------------------- accumulate
    def accumulate(self):
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat in enumerate(p.catIds):
            for a in range(A):
                per_img = [self.evalImgs.get((img, cat, a))
                           for img in p.imgIds]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    stats = self._pr_curves(per_img, maxDet, T, R, p.recThrs)
                    if stats is None:
                        continue
                    precision[:, :, k, a, m] = stats[0]
                    recall[:, k, a, m] = stats[1]
                    scores[:, :, k, a, m] = stats[2]
        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores, "params": p}

    def _pr_curves(self, per_img, maxDet, T, R, recThrs):
        dt_scores, dtm, dt_ig, n_gt = [], [], [], 0
        for e in per_img:
            n_gt += e["n_gt"]
            sel = slice(0, maxDet)
            dt_scores.append(e["dt_scores"][sel])
            dtm.append(e["dtm"][:, sel])
            dt_ig.append(e["dt_ig"][:, sel])
        if not dt_scores:
            return None
        dt_scores = np.concatenate(dt_scores)
        dtm = np.concatenate(dtm, axis=1)
        dt_ig = np.concatenate(dt_ig, axis=1)

        order = np.argsort(-dt_scores, kind="mergesort")
        dtm = dtm[:, order]
        dt_ig = dt_ig[:, order]
        sorted_scores = dt_scores[order]

        tps = (dtm > 0) & ~dt_ig
        fps = (dtm == 0) & ~dt_ig
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        precision = np.zeros((T, R))
        recall = np.zeros((T,))
        score_out = np.zeros((T, R))
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / n_gt if n_gt > 0 else np.zeros_like(tp)
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            recall[t] = rc[-1] if nd else 0.0
            # precision envelope (monotone non-increasing from the right)
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, recThrs, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    precision[t, ri] = pr[pi]
                    score_out[t, ri] = sorted_scores[pi]
        if n_gt == 0:
            precision[:] = -1
            recall[:] = -1
            score_out[:] = -1
        return precision, recall, score_out

    # ----------------------------------------------------------- summarize
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        mean_s = -1.0 if valid.size == 0 else float(valid.mean())
        kind = "Average Precision" if ap else "Average Recall"
        thr_s = (f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}"
                 if iouThr is None else f"{iouThr:0.2f}")
        print(f" {kind:<18} (AP) @[ IoU={thr_s:<9} | area={areaRng:>6} | "
              f"maxDets={maxDets:>3} ] = {mean_s:0.3f}")
        return mean_s

    def summarize(self):
        if not self.eval:
            raise RuntimeError("run accumulate() first")
        p = self.params
        if p.iouType == "keypoints":
            md = p.maxDets[0]
            stats = np.array([
                self._summarize(1, maxDets=md),
                self._summarize(1, iouThr=0.5, maxDets=md),
                self._summarize(1, iouThr=0.75, maxDets=md),
                self._summarize(1, areaRng="medium", maxDets=md),
                self._summarize(1, areaRng="large", maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, iouThr=0.5, maxDets=md),
                self._summarize(0, iouThr=0.75, maxDets=md),
                self._summarize(0, areaRng="medium", maxDets=md),
                self._summarize(0, areaRng="large", maxDets=md),
            ])
        else:
            stats = np.array([
                self._summarize(1, maxDets=p.maxDets[-1]),
                self._summarize(1, iouThr=0.5, maxDets=p.maxDets[-1]),
                self._summarize(1, iouThr=0.75, maxDets=p.maxDets[-1]),
                self._summarize(1, areaRng="small", maxDets=p.maxDets[-1]),
                self._summarize(1, areaRng="medium", maxDets=p.maxDets[-1]),
                self._summarize(1, areaRng="large", maxDets=p.maxDets[-1]),
                self._summarize(0, maxDets=p.maxDets[0]),
                self._summarize(0, maxDets=p.maxDets[1]),
                self._summarize(0, maxDets=p.maxDets[-1]),
                self._summarize(0, areaRng="small", maxDets=p.maxDets[-1]),
                self._summarize(0, areaRng="medium", maxDets=p.maxDets[-1]),
                self._summarize(0, areaRng="large", maxDets=p.maxDets[-1]),
            ])
        self.stats = stats
        return stats
