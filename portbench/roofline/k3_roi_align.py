"""K3, RoIAlign (``kernels/roi_align.py``): 7 x 7 bins of 2 x 2 samples a
box on its level of the FPN maps. Bytes: the pooled features written,
the distinct map pixels nearest to the sample points read once each (all
channels), the boxes and levels. The arithmetic (four taps a sample) is
far below the f32 peak's share of the time."""

import torch

from portbench.harness import F32_PEAK

ENTRY = ("stlpose_tpu_torch.kernels.roi_align", "roi_align")
KERNELS = ("roi_align_kernel",)


def capture(args, kwargs, out):
    levels, boxes, lv, strides = args[:4]
    return {"shapes": [tuple(f.shape) for f in levels],
            "itemsize": levels[0].element_size(), "boxes": boxes,
            "levels": lv, "strides": list(strides),
            "out_bytes": out.numel() * out.element_size()}


def work(inp, out=7, sr=2):
    boxes = inp["boxes"].float()
    B, P = boxes.shape[:2]
    flat = boxes.reshape(-1, 4)
    lv = inp["levels"].reshape(-1).long()
    img = torch.arange(B, device=boxes.device).repeat_interleave(P)
    s = torch.arange(out * sr, device=boxes.device)
    pos = (s // sr).float() + ((s % sr).float() + 0.5) / sr
    read = 0
    for li, (shape, stride) in enumerate(zip(inp["shapes"],
                                             inp["strides"])):
        sel = lv == li
        if not bool(sel.any()):
            continue
        _, h, w, c = shape
        bb = flat[sel] / stride

        def axis(lo, hi, size):
            g = lo[:, None] + pos[None] * (torch.clamp(hi - lo, min=1.0) /
                                           out)[:, None]
            ok = (g >= -1.0) & (g <= size)
            return torch.floor(g.clamp(0, size - 1) + 0.5).long(), ok

        xs, okx = axis(bb[:, 0], bb[:, 2], w)
        ys, oky = axis(bb[:, 1], bb[:, 3], h)
        lin = ((img[sel][:, None, None] * h + ys[:, :, None]) * w +
               xs[:, None, :])
        ok = oky[:, :, None] & okx[:, None, :]
        read += int(torch.unique(lin[ok]).numel()) * c * inp["itemsize"]
    nbytes = inp["out_bytes"] + read + B * P * 20
    return 0.0, nbytes, F32_PEAK
