"""Plain functional forwards of HRNet (Sun et al., CVPR 2019) and Faster
R-CNN with a ResNet-50-FPN trunk (torchvision's ``fasterrcnn_resnet50_fpn``
layout), over a flat state dict ``W`` (name -> tensor) and the sizes of a
``portbench/configs`` file. Convolutions and dense layers are
``F.conv2d`` and ``F.linear`` in float32 (the caller sets TF32), NCHW.
The parameter names are those the benchmark's seeded weights carry.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import ops


def _bn(W, p, x, train: bool):
    if train:
        return F.batch_norm(x, None, None, W[p + ".weight"], W[p + ".bias"],
                            True, 0.0, 1e-5)
    return F.batch_norm(x, W[p + ".running_mean"], W[p + ".running_var"],
                        W[p + ".weight"], W[p + ".bias"], False, 0.0, 1e-5)


def conv_bn(W, p, x, stride=1, relu=True, train=False):
    w = W[p + ".conv.weight"]
    y = F.conv2d(x, w, W.get(p + ".conv.bias"), stride, w.shape[-1] // 2)
    if p + ".bn.weight" in W:
        y = _bn(W, p + ".bn", y, train)
    return F.relu(y) if relu else y


def _residual(W, p, x, y, stride, train):
    if p + ".down.conv.weight" in W:
        x = conv_bn(W, p + ".down", x, stride, False, train)
    return F.relu(y + x)


def bottleneck(W, p, x, stride=1, train=False):
    y = conv_bn(W, p + ".cb1", x, 1, True, train)
    y = conv_bn(W, p + ".cb2", y, stride, True, train)
    y = conv_bn(W, p + ".cb3", y, 1, False, train)
    return _residual(W, p, x, y, stride, train)


def basic_block(W, p, x, train=False):
    y = conv_bn(W, p + ".cb1", x, 1, True, train)
    y = conv_bn(W, p + ".cb2", y, 1, False, train)
    return _residual(W, p, x, y, 1, train)


def _up(x, f):
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


# ------------------------------------------------------------------- HRNet
def _hr_module(W, p, xs, st, n_out, train):
    ys = []
    for b in range(st["num_branches"]):
        y = xs[b]
        for k in range(st["num_blocks"][b]):
            y = basic_block(W, f"{p}.branch{b}_block{k}", y, train)
        ys.append(y)
    if st["num_branches"] == 1:
        return ys
    out = []
    for i in range(n_out):
        acc = None
        for j in range(st["num_branches"]):
            if j == i:
                z = ys[j]
            elif j > i:
                z = _up(conv_bn(W, f"{p}.fuse{i}_{j}", ys[j], 1, False,
                                train), 2 ** (j - i))
            else:
                z = ys[j]
                for k in range(i - j):
                    z = conv_bn(W, f"{p}.fuse{i}_{j}_{k}", z, 2,
                                k < i - j - 1, train)
            acc = z if acc is None else acc + z
        out.append(F.relu(acc))
    return out


def hrnet(W, cfg, images_nhwc, train=False):
    """(N, H, W, 3) normalised crops -> (N, J, H/4, W/4) heatmaps."""
    x = images_nhwc.permute(0, 3, 1, 2).contiguous()
    x = conv_bn(W, "stem1", x, 2, True, train)
    x = conv_bn(W, "stem2", x, 2, True, train)
    for k in range(cfg["stage1_num_blocks"]):
        x = bottleneck(W, f"layer1_{k}", x, 1, train)
    xs, n_prev = [x], 1
    stages = cfg["stages"]
    for s, st in enumerate(stages, start=2):
        nxt = []
        for i in range(st["num_branches"]):
            if i < n_prev:
                name = f"transition{s - 1}_{i}"
                nxt.append(conv_bn(W, name, xs[i], 1, True, train)
                           if name + ".conv.weight" in W else xs[i])
            else:
                z = xs[-1]
                for j in range(i + 1 - n_prev):
                    z = conv_bn(W, f"transition{s - 1}_{i}_{j}", z, 2, True,
                                train)
                nxt.append(z)
        xs = nxt
        for m in range(st["num_modules"]):
            last = s == len(stages) + 1 and m == st["num_modules"] - 1
            n_out = (1 if last else st["num_branches"]) \
                if st["num_branches"] > 1 else 0
            xs = _hr_module(W, f"stage{s}_m{m}", xs, st, n_out, train)
        n_prev = st["num_branches"]
    w = W["final_layer.weight"]
    return F.conv2d(xs[0], w, W["final_layer.bias"], 1, w.shape[-1] // 2)


def hrnet_flip(W, cfg, crops_nhwc):
    """Flip-test heatmaps: one forward of the crops and their mirrors."""
    n = crops_nhwc.shape[0]
    hm = hrnet(W, cfg, torch.cat([crops_nhwc,
                                  torch.flip(crops_nhwc, dims=[2])]))
    return ops.flip_tta(hm[:n], hm[n:])


# ------------------------------------------------------------ Faster R-CNN
def resnet(W, cfg, images_nchw):
    """The ResNet trunk: [C2, C3, C4, C5] NCHW."""
    x = F.conv2d(images_nchw, W["backbone.stem_conv.weight"], None, 2, 3)
    x = F.relu(_bn(W, "backbone.stem_bn", x, False))
    x = F.max_pool2d(x, 3, 2, padding=1)
    cs = []
    for s, n in enumerate(cfg["stage_sizes"]):
        for b in range(n):
            x = bottleneck(W, f"backbone.layer{s + 1}_{b}", x,
                           2 if s > 0 and b == 0 else 1)
        cs.append(x)
    return cs


def features(W, cfg, images_nchw):
    """ResNet trunk + FPN: [P2, P3, P4, P5, P6] NCHW."""
    cs = resnet(W, cfg, images_nchw)
    lat = [F.conv2d(c, W[f"fpn.lateral{i}.weight"], W[f"fpn.lateral{i}.bias"])
           for i, c in enumerate(cs)]
    outs = [lat[-1]]
    for i in range(len(lat) - 2, -1, -1):
        th, tw = lat[i].shape[2:]
        outs.insert(0, lat[i] + _up(outs[0], 2)[:, :, :th, :tw])
    ps = [F.conv2d(o, W[f"fpn.out{i}.weight"], W[f"fpn.out{i}.bias"], 1, 1)
          for i, o in enumerate(outs)]
    return ps + [F.max_pool2d(ps[-1], 1, 2)]


def rpn_head(W, feats):
    logits, deltas = [], []
    for f in feats:
        t = F.relu(F.conv2d(f, W["rpn_head.conv.weight"],
                            W["rpn_head.conv.bias"], 1, 1))
        logits.append(F.conv2d(t, W["rpn_head.cls.weight"],
                               W["rpn_head.cls.bias"]))
        deltas.append(F.conv2d(t, W["rpn_head.reg.weight"],
                               W["rpn_head.reg.bias"]))
    return logits, deltas


def box_head(W, pooled):
    x = pooled.reshape(pooled.shape[0], -1)
    x = F.relu(F.linear(x, W["box_head.fc6.weight"], W["box_head.fc6.bias"]))
    x = F.relu(F.linear(x, W["box_head.fc7.weight"], W["box_head.fc7.bias"]))
    return (F.linear(x, W["box_head.cls_score.weight"],
                     W["box_head.cls_score.bias"]),
            F.linear(x, W["box_head.bbox_pred.weight"],
                     W["box_head.bbox_pred.bias"]))


def anchors(cfg, shapes, device):
    """Per level (h*w*A, 4) xyxy anchors in (h, w, a) order."""
    out = []
    for (h, w), stride, size in zip(shapes, cfg["strides"],
                                    cfg["anchor_sizes"]):
        base = []
        for r in cfg["anchor_ratios"]:
            bw, bh = size * np.sqrt(1.0 / r), size * np.sqrt(r)
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)
        cx, cy = np.meshgrid(np.arange(w, dtype=np.float32) * stride,
                             np.arange(h, dtype=np.float32) * stride)
        shifts = np.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        out.append(torch.from_numpy((shifts + base[None]).reshape(-1, 4))
                   .to(device))
    return out


def detect(W, cfg, images01):
    """(B, S, S, 3) images in [0, 1] -> the person class's candidates:
    boxes (B, P, 4) decoded from every post-NMS proposal, scores (B, P),
    and the mask of those that pass the score threshold and the detection
    NMS (``detections_per_img`` picks)."""
    B = images01.shape[0]
    S = float(cfg["image_size"])
    feats = features(W, cfg, images01.permute(0, 3, 1, 2).contiguous())
    lg, dl = rpn_head(W, feats)
    anch = anchors(cfg, [tuple(x.shape[2:]) for x in lg], images01.device)
    lg = [x.permute(0, 2, 3, 1).reshape(B, -1) for x in lg]
    dl = [x.permute(0, 2, 3, 1).reshape(B, -1, 4) for x in dl]
    cb, cs, cl = [], [], []
    for li, (a, s, d) in enumerate(zip(anch, lg, dl)):
        k = min(cfg["pre_nms_top_n_test"], s.shape[1])
        ts, ti = ops.top_k(s, k)
        dd = torch.gather(d, 1, ti[..., None].expand(-1, -1, 4))
        cb.append(ops.clip_boxes(ops.decode_boxes(dd, a[ti]), S))
        cs.append(ts)
        cl.append(torch.full((k,), float(li), device=s.device))
    boxes, scores, lv = torch.cat(cb, 1), torch.cat(cs, 1), torch.cat(cl)
    wh_ok = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & \
        ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
    post = cfg["post_nms_top_n_test"]
    keep = ops.greedy_nms(boxes + lv[None, :, None] * (S * 2.0),
                          torch.where(wh_ok, scores, -torch.inf),
                          wh_ok, cfg["rpn_nms_thresh"], post)
    _, ti = ops.top_k(torch.where(keep, scores, -torch.inf), post)
    props = torch.gather(boxes, 1, ti[..., None].expand(-1, -1, 4))
    levels = [f.permute(0, 2, 3, 1).contiguous() for f in feats[:4]]
    pooled = ops.roi_align(levels, props, cfg["strides"][:4])
    P = props.shape[1]
    cls, reg = box_head(W, pooled.reshape(B * P, *pooled.shape[2:]))
    nc = cfg["num_classes"]
    e = torch.exp(cls - cls.amax(-1, keepdim=True))
    prob = (e / e.sum(-1, keepdim=True)).reshape(B, P, nc)
    d = reg.reshape(B, P, nc, 4)[:, :, 1]
    cand = ops.clip_boxes(ops.decode_boxes(d, props, cfg["box_weights"]), S)
    sc = prob[..., 1]
    ok = sc > cfg["score_thresh"]
    kept = ops.greedy_nms(cand, torch.where(ok, sc, -torch.inf), ok,
                          cfg["nms_thresh"], cfg["detections_per_img"]) & ok
    return cand, sc, kept
